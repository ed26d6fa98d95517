"""Image operations (visualslam_tpu/ops/__init__.py's names). The CUDA
kernels are in `ops.cuda`; nothing is built or loaded at import.
`ops.gradients` stays the module (callers import it as one): the function
of that name is `ops.gradients.gradients`."""

from visualslam_tpu_torch.ops.blur import blur_stack, box_filter, gaussian_blur, gaussian_taps  # noqa: F401
from visualslam_tpu_torch.ops.gradients import central_diff, magnitude_orientation  # noqa: F401
from visualslam_tpu_torch.ops.harris import harris_response  # noqa: F401
from visualslam_tpu_torch.ops.nms import window_max, window_peaks  # noqa: F401
from visualslam_tpu_torch.ops.resize import downsample2x_nearest, upsample2x_linear  # noqa: F401
