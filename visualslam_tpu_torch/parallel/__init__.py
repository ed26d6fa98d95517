"""Parallel paths over an in-process device mesh
(visualslam_tpu/parallel/): `mesh`, `collectives`, `dist_match`,
`dist_ba`, `traj_ba`, `pipeline`, `multihost` and `dryrun`."""

from visualslam_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
