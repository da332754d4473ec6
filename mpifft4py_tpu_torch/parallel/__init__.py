"""The distributed tier: the slab's process group and the pencil's grid of
sub-groups (``mesh``), the runtime (``runtime.initialize``,
``runtime.hybrid_mesh``), the collective transposes (``collectives``) and
the peer-memory kernels of rows 23-27 (``rdma``)."""

from .mesh import (check_divisible, pencil_comm, pencil_groups,  # noqa: F401
                   slab_group)
