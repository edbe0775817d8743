# Distributed unified pool: N superchips as one logical memory system.
# Importing this package registers the cluster hardware models (gh200_x2,
# gh200_x4) and the node-aware policies (cluster_system, cluster_striped)
# with repro_torch.core.registry — core/registry.py imports it at the bottom so
# every registry consumer sees the cluster backends without extra imports.
from repro_torch.cluster.topology import (  # noqa: F401
    GH200_X2,
    GH200_X4,
    ClusterHardwareModel,
    ClusterTopology,
    gh200_cluster,
)
from repro_torch.cluster.policy import (  # noqa: F401
    ClusterPolicy,
    ClusterStripedPolicy,
    ClusterSystemPolicy,
    cluster_striped_policy,
    cluster_system_policy,
    device_free_on,
    device_used_on,
    node_capacity,
)
from repro_torch.cluster.serve import ClusterTPPlan  # noqa: F401
