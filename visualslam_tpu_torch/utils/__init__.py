from visualslam_tpu_torch.utils.masked import (  # noqa: F401
    compact,
    masked_mean,
    merge,
    top_k_select,
)
