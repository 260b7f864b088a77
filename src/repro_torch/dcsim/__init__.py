"""The simulated geo-distributed fleet (port of ``repro.dcsim``).

``env.build_env`` builds one day's ``EnvParams`` on the card (or the CPU);
``env.step_epoch`` simulates an hour; ``env.player_reward`` is the game's
per-player objective. Construction is host-side numpy (``topology``,
``colocation``, ``power``, ``renewables``, ``workload``, ``capability``), with
the JAX package's RNG streams, so every field equals the reference's.
"""
from .env import (OBJECTIVES, EnvParams, build_env, pad_env_batch, stack_envs,
                  step_epoch, tile_env)

__all__ = ["OBJECTIVES", "EnvParams", "build_env", "pad_env_batch", "stack_envs",
           "step_epoch", "tile_env"]
