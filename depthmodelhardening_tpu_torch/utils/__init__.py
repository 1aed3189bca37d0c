from .logging import MetricsLogger, sec_to_hm_str  # noqa: F401
from .profiling import StepTimer, trace  # noqa: F401
from .seeding import setup_seed  # noqa: F401
from .visualize import (  # noqa: F401
    colormap_disp, eval_depth_diff, normalize_image, save_pic,
)
