from dgraph_tpu_torch.audit.audit import AuditLog
