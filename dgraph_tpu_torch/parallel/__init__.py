from dgraph_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_kmeans_step,
    sharded_topk,
    sharded_membership,
    sharded_ivf_train,
)
