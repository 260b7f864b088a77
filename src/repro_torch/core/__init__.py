"""Public API of the port's evaluation system (``repro.core``'s names).

    from repro_torch.core import ExperimentSpec, run, compare_techniques
    from repro_torch.dcsim.env import build_env

    run(ExperimentSpec(technique="gt-drl", hours=24), build_env(4, seed=0))

``run`` plays the carbon/cost game on the envs' device (the card unless
``build_env`` was asked for the CPU): one day (scan, loop), a batch of
scenario-days under one vmap (batched) or days in a row (month), optionally
against a realized ``faults.FaultTrace``; ``sweep`` runs severity grids of
``scenarios``. The paper's six techniques are registered (fd, ga, nash,
ddpg, ppo, gt-drl); ``compare_techniques`` ranks them; external solvers plug
in via ``register_technique``.
"""
from .experiment import ENGINES, ExperimentSpec, run, sweep
from .game import (GameContext, SolveResult, TechniqueDef, get_technique,
                   register_technique, technique_names,
                   unregister_technique)
from .schedulers import (TECHNIQUES, compare_techniques, get_scheduler,
                         run_day, run_days_batched, run_month)

__all__ = [
    "ENGINES", "ExperimentSpec", "run", "sweep",
    "GameContext", "SolveResult", "TechniqueDef", "get_technique",
    "register_technique", "technique_names", "unregister_technique",
    "TECHNIQUES", "compare_techniques", "get_scheduler",
    "run_day", "run_days_batched", "run_month",
]
