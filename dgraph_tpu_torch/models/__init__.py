from dgraph_tpu_torch.models.vector import VectorIndex
