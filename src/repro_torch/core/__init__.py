"""Public API of the port's evaluation system (``repro.core``'s names).

    from repro_torch.core import ExperimentSpec, run
    from repro_torch.dcsim.env import build_env

    run(ExperimentSpec(technique="fd", hours=24), build_env(4, seed=0))

``run`` plays one day of the carbon/cost game on the env's device (the card
unless ``build_env`` was asked for the CPU). fd and nash are registered;
external solvers plug in via ``register_technique``.
"""
from .experiment import ENGINES, ExperimentSpec, run
from .game import (GameContext, SolveResult, TechniqueDef, get_technique,
                   register_technique, technique_names,
                   unregister_technique)

__all__ = [
    "ENGINES", "ExperimentSpec", "run",
    "GameContext", "SolveResult", "TechniqueDef", "get_technique",
    "register_technique", "technique_names", "unregister_technique",
]
