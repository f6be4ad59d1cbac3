"""Sweeps over many frame pairs (counterpart of ofot_tpu.parallel): the
map-mode batch solve (``sweep``) and the host partition of a sweep
(``multihost``).  The mesh, sharding and halo-exchange modules of the JAX
package are not ported yet."""
