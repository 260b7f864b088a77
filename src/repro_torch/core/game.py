"""The non-cooperative workload-distribution game (paper §4–§5.1).

The port of ``repro.core.game``. Players are task types i ∈ I; a strategy is
the simplex row of desired fractions DF_i (eq. 21) which maps to arrival
rates AR_i = DF_i · CAR_i; player i's reward is its own estimated carbon
CET_i (eq. 12) or cost CCT_i (eq. 17) given everyone's strategies. The
solution concept is Nash equilibrium (eqs. 19/20).

Routed games (``GameContext.routed``): player i's strategy grows to an
(S, D) matrix — one simplex row per source region — and the joint strategy
is the (S, I, D) routing tensor. The player axis is always ``-2`` and the DC
simplex rows ``-1``, so the same solver code drives both games.

Gradients come from ``torch.func.grad_and_value`` (``grad_of``), so that the
solvers also run under ``torch.func.vmap``; a player's row is written out of
place (``replace_player``) so that the transform sees the write.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import obs
from ..dcsim import env as E
from ..dcsim import ties


@dataclasses.dataclass(frozen=True)
class GameContext:
    """One epoch's decision problem. ``routed`` switches the joint-strategy
    shape from (I, D) to the (S, I, D) routing tensor."""
    env: E.EnvParams
    tau: int
    objective: str = "carbon"  # carbon | cost | cost_sla (E.OBJECTIVES)
    routed: bool = False

    def num_players(self) -> int:
        return E.num_players(self.env)

    def num_dcs(self) -> int:
        return E.num_dcs(self.env)

    def num_sources(self) -> int:
        return E.num_sources(self.env)

    def is_routed(self) -> bool:
        """Whether the joint strategy actually carries a source axis. With the
        S = 1 aggregate origin there is nothing to route, so the routed game
        runs the unrouted program, as in the JAX package."""
        return self.routed and self.num_sources() > 1

    def joint_shape(self) -> Tuple[int, ...]:
        """Shape of the joint strategy: (S, I, D) routed, (I, D) otherwise."""
        i, d = self.num_players(), self.num_dcs()
        return (self.num_sources(), i, d) if self.is_routed() else (i, d)


def fractions_to_ar(ctx: GameContext, fractions: torch.Tensor) -> torch.Tensor:
    """Simplex rows -> feasible AR (eqs. 1, 2, 21): (I, D) -> (I, D), or the
    routed (S, I, D) tensor -> per-path AR3 (S, I, D)."""
    if ctx.is_routed():
        return E.project_feasible_routed(ctx.env, fractions, ctx.tau)
    return E.project_feasible(ctx.env, fractions, ctx.tau)


def uniform_fractions(ctx: GameContext) -> torch.Tensor:
    return torch.full(ctx.joint_shape(), 1.0 / ctx.num_dcs(), dtype=ctx.env.er.dtype,
                      device=ctx.env.er.device)


def capacity_fractions(ctx: GameContext) -> torch.Tensor:
    """Effective-ER-proportional start (a natural feasible point); routed
    games broadcast the same source-blind split to every source region."""
    er_t = E.capacity_at(ctx.env, ctx.tau)
    f = er_t / ties.maximum(torch.sum(er_t, dim=1, keepdim=True), 1e-9)
    return f.expand(ctx.joint_shape()) if ctx.is_routed() else f


def player_rewards(
    ctx: GameContext, fractions: torch.Tensor, peak_state: torch.Tensor
) -> torch.Tensor:
    """(I,) per-player objective values (lower better)."""
    ar = fractions_to_ar(ctx, fractions)
    return E.player_reward(ctx.env, ar, ctx.tau, peak_state, ctx.objective)


def cloud_objective(
    ctx: GameContext, fractions: torch.Tensor, peak_state: torch.Tensor
) -> torch.Tensor:
    """Scalar cloud-level objective (eq. 13 or 18)."""
    return torch.sum(player_rewards(ctx, fractions, peak_state))


def player_row(fractions: torch.Tensor, i: int) -> torch.Tensor:
    """Player i's strategy: (D,) from (I, D), or (S, D) from (S, I, D)."""
    return fractions[..., i, :]


def replace_player(fractions: torch.Tensor, i: int, row: torch.Tensor) -> torch.Tensor:
    """``fractions`` with player i's row set to ``row``, out of place (the
    ``.at[..., i, :].set`` of the JAX package), so gradients reach ``row``."""
    return torch.cat([fractions[..., :i, :], row.unsqueeze(-2), fractions[..., i + 1:, :]],
                     dim=-2)


def player_objective(
    ctx: GameContext, fractions: torch.Tensor, i: int, row: torch.Tensor,
    peak_state: torch.Tensor,
) -> torch.Tensor:
    """Player i's reward when it unilaterally plays ``row``."""
    f = replace_player(fractions, i, row)
    return player_rewards(ctx, f, peak_state)[i]


def grad_of(fn: Callable[[torch.Tensor], torch.Tensor],
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fn(x), d fn / d x) by ``torch.func.grad_and_value``: no graph
    outlives the call, and it runs under ``torch.func.vmap`` (the batched
    engine's rows)."""
    g, value = torch.func.grad_and_value(fn)(x)
    return value, g


def nash_residual(
    ctx: GameContext,
    fractions: torch.Tensor,
    peak_state: torch.Tensor,
    probe_steps: int = 25,
    lr: float = 0.5,
) -> torch.Tensor:
    """How far from Nash: max relative unilateral improvement any player can
    find with a short projected-gradient probe. 0 at (local) equilibrium."""
    with torch.no_grad():
        base = player_rewards(ctx, fractions, peak_state)
    gains = []
    for i in range(fractions.shape[-2]):
        def obj(logits, i=i):
            return player_objective(ctx, fractions, i, torch.softmax(logits, dim=-1),
                                    peak_state)

        logits = torch.log(player_row(fractions, i) + 1e-9)
        for _ in range(probe_steps):
            _, g = grad_of(obj, logits)
            logits = logits - lr * g / (torch.linalg.vector_norm(g) + 1e-9)
        with torch.no_grad():
            best = obj(logits)
        gains.append(ties.maximum(base[i] - best, 0.0) / (torch.abs(base[i]) + 1e-9))
    return torch.max(torch.stack(gains))


def tap_nash_residual(
    ctx: GameContext,
    fractions: torch.Tensor,
    peak_state: torch.Tensor,
    probe_steps: int = 8,
    lr: float = 0.5,
) -> None:
    """Telemetry hook: stream the Nash-residual diagnostic per epoch.

    A no-op unless the ``"game/nash_residual"`` tap is live (see
    ``repro_torch.obs``): the probe is |I| short gradient ascents, so it is
    only computed then. ``probe_steps`` defaults lower than the offline
    diagnostic: a per-epoch convergence signal, not a certificate.
    """
    obs.tap("game/nash_residual",
            thunk=lambda: {"tau": ctx.tau,
                           "residual": nash_residual(ctx, fractions, peak_state,
                                                     probe_steps=probe_steps, lr=lr)})


# ---------------------------------------------------------------------------
# scheduler interface: every technique maps a GameContext to fractions
# ---------------------------------------------------------------------------

class SolveResult(NamedTuple):
    fractions: torch.Tensor       # (I, D), or (S, I, D) for routed games
    info: Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# technique registry: the one name -> solver lookup the engine uses
# ---------------------------------------------------------------------------

def _stateless_init(gen, env, objective, cfg, routed: bool, pretrain: bool):
    """Solver state for a stateless technique: the empty carry."""
    return ()


class TechniqueDef(NamedTuple):
    """One registered technique.

    ``step(gen, state, ctx, peak_state, cfg) -> (state, SolveResult)`` is
    what the engine calls each hour (``gen`` is a ``torch.Generator``;
    ``state`` threads the solver carry, ``()`` for stateless solvers);
    ``init_state(gen, env, objective, cfg, routed, pretrain)`` builds the
    initial carry.

    The batched engine runs the hour of every row under one
    ``torch.func.vmap``, where no generator can draw. A technique that draws
    splits its step: ``draw(gen, ctx, cfg, device)`` makes every draw of one
    hour (a tree of tensors), and ``compute(draws, state, ctx, peak_state,
    cfg) -> (state, SolveResult)`` is the step from them. Without the split,
    the step runs there with ``gen=None`` (fd and nash draw nothing).
    """
    name: str
    step: Callable[..., Tuple[Any, SolveResult]]
    default_cfg: Any = None
    init_state: Callable[..., Any] = _stateless_init
    stateful: bool = False
    draw: Optional[Callable[..., Any]] = None
    compute: Optional[Callable[..., Tuple[Any, SolveResult]]] = None

    def resolve_cfg(self, cfg: Any) -> Any:
        """``cfg`` if given, else the registered default."""
        return cfg if cfg is not None else self.default_cfg

    def split(self) -> Tuple[Optional[Callable], Callable]:
        """(draw or None, compute): the step as the batched engine runs it."""
        if self.compute is not None:
            return self.draw, self.compute
        step = self.step

        def compute(draws, state, ctx, peak_state, cfg):
            return step(None, state, ctx, peak_state, cfg)
        return None, compute


_TECHNIQUES: Dict[str, TechniqueDef] = {}


def register_technique(
    name: str,
    solve_epoch: Optional[Callable] = None,
    *,
    step: Optional[Callable] = None,
    default_cfg: Any = None,
    init_state: Optional[Callable] = None,
    stateful: bool = False,
    overwrite: bool = False,
    draw: Optional[Callable] = None,
    compute: Optional[Callable] = None,
) -> TechniqueDef:
    """Register a technique so ``ExperimentSpec`` can drive it by name.

    Pass exactly one of ``solve_epoch(gen, ctx, peak_state, cfg=...) ->
    SolveResult`` (a stateless solver) or ``step(gen, state, ctx, peak_state,
    cfg) -> (state, SolveResult)`` with ``init_state`` and ``stateful=True``.
    ``draw`` and ``compute`` split the step for the batched engine
    (``TechniqueDef``); ``compute`` takes the form of the step given:
    ``compute(draws, ctx, peak_state, cfg)`` beside ``solve_epoch``.
    """
    if (solve_epoch is None) == (step is None):
        raise ValueError("pass exactly one of solve_epoch= or step=")
    if (draw is None) != (compute is None):
        raise ValueError("pass both draw= and compute=, or neither")
    if solve_epoch is not None:
        fn = solve_epoch

        def step(gen, state, ctx, peak_state, cfg):
            return state, fn(gen, ctx, peak_state, cfg=cfg)
        if compute is not None:
            solve_drawn = compute

            def compute(draws, state, ctx, peak_state, cfg):
                return state, solve_drawn(draws, ctx, peak_state, cfg)
    if name in _TECHNIQUES:
        if not overwrite:
            raise KeyError(f"technique {name!r} already registered (overwrite=True rebinds)")
        obs.spans.note_eviction()  # the name's engine stats no longer describe it
    t = TechniqueDef(name, step, default_cfg, init_state or _stateless_init, stateful, draw,
                     compute)
    _TECHNIQUES[name] = t
    return t


def unregister_technique(name: str) -> None:
    """Remove a registered technique (no error if it is not there); the
    engine stats count it as an eviction, as the reference's caches do."""
    if _TECHNIQUES.pop(name, None) is not None:
        obs.spans.note_eviction()


def get_technique(name: str) -> TechniqueDef:
    try:
        return _TECHNIQUES[name]
    except KeyError:
        raise KeyError(
            f"unknown technique {name!r}; registered: {technique_names()}") from None


def technique_names() -> Tuple[str, ...]:
    return tuple(_TECHNIQUES)
