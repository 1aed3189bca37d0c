"""What the benchmark takes from the program under test: the entries a
cell drives, the models it builds them with, the device set-up the
command line makes, and the kernels' build and launch counters."""

from __future__ import annotations

PORT = "depthmodelhardening_tpu_torch"


def load():
    """The program's names, imported now (a directory without the
    program fails here, before any result)."""
    from types import SimpleNamespace

    from depthmodelhardening_tpu_torch.device import use_f32_numerics
    from depthmodelhardening_tpu_torch.evaluation import attack_eval
    from depthmodelhardening_tpu_torch.models.wrappers import (
        make_monodepth2, predictor_from,
    )
    from depthmodelhardening_tpu_torch.ops import _build
    from depthmodelhardening_tpu_torch.training import config
    from depthmodelhardening_tpu_torch.training.hardening import (
        HardeningTrainer, make_family_model,
    )

    return SimpleNamespace(
        use_f32_numerics=use_f32_numerics, attack_eval=attack_eval,
        make_monodepth2=make_monodepth2, predictor_from=predictor_from,
        build=_build, config=config, HardeningTrainer=HardeningTrainer,
        make_family_model=make_family_model)
