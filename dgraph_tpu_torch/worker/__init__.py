from dgraph_tpu_torch.worker.groups import DistributedCluster, ZeroService
