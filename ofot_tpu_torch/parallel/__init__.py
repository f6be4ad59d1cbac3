"""The distribution layer (counterpart of ofot_tpu.parallel): meshes of
ranks (``mesh``), halo-exchange stencils (``halo``), tiled solves
(``foto_sharded``, ``wfr_sharded``, ``gn_sharded``, ``gspmd``), batch
sweeps over a ``data`` axis (``sweep``), local worlds (``launch``) and
multi-process scaffolding (``multihost``, ``multihost_worker``)."""

from ofot_tpu_torch.parallel import mesh, gspmd, halo, sweep  # noqa: F401
