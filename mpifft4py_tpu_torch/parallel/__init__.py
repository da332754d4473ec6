"""The distributed tier: the slab's process group (``mesh``), the
runtime (``runtime.initialize``), the collective transposes
(``collectives``) and the peer-memory kernels of rows 23-25 (``rdma``)."""

from .mesh import check_divisible, slab_group  # noqa: F401
