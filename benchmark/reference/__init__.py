"""The plain reference that decides `correct`: plain PyTorch, float32,
TF32 off, no kernel of the program (a frozen copy of its plain paths,
`plain/`), and the controls one precision below (`numerics`). It
imports neither jax nor the JAX package nor anything of the program."""

from .numerics import bf16, float32, fp8, tf32  # noqa: F401
from .plain.attacks.base import PhysObjAttackConfig  # noqa: F401
from .plain.attacks.pgd_object import PGDObjectAttack  # noqa: F401
from .plain.models.pose import make_pose_nets  # noqa: F401
from .plain.models.resnet import encoder_channels  # noqa: F401
from .plain.models.simsiam import SimSiam  # noqa: F401
from .plain.models.wrappers import make_monodepth2, predictor_from  # noqa
from .plain.ops.metrics import (  # noqa: F401
    compute_errors_masked, scaled_clamped_depth,
)
from .plain.ops.resize import bilinear_resize  # noqa: F401
from .plain.physics.eot import VEHICLE_SIZES  # noqa: F401
from .plain.training import config  # noqa: F401
from .plain.training.hardening import (  # noqa: F401
    HardeningTrainer, make_family_model,
)
