from dgraph_tpu_torch.raft.raft import RaftNode, InProcNetwork
