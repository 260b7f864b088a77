"""GA: Genitor-style steady-state genetic algorithm (technique (b), [16]).

The port of ``repro.core.genetic``. Population of strategy matrices;
rank-based parent selection (Genitor [44]), player-wise arithmetic
crossover, Dirichlet mutation, replace-worst. The generation budget models
the paper's one-hour wall-clock cap.

Each generation's draws come in as ``GenerationDraws`` (``draw_generation``).
The parents' choice depends on the fitness ranks and the mutation on the
child, both on the device, so the host draws their uniforms and Gamma tries
and the device finishes them (``core.draws``); the tests inject the drawn
values instead. ``draw_epoch`` draws a whole solve at once (the batched
engine stacks one per row), ``solve_drawn`` computes from it, and
``solve_epoch`` is the two in turn.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import vmap

from ..tree import tree_map
from .draws import choice, dirichlet, draw_gammas, stack_draws, to_device
from .game import GameContext, SolveResult, cloud_objective, uniform_fractions


@dataclasses.dataclass(frozen=True)
class GAConfig:
    population: int = 32
    generations: int = 150   # fixed budget ≈ the paper's 1-hour cap
    mutate_prob: float = 0.3
    mutate_conc: float = 25.0  # Dirichlet concentration (higher = smaller step)


class GenerationDraws(NamedTuple):
    pa: torch.Tensor       # (1,) parent index, or the uniform it is chosen by
    pb: torch.Tensor       # (1,)
    mix: torch.Tensor      # (I, 1) crossover weights
    mut: object            # Gammas, or the (*joint) Dirichlet mutation
    do_mut: torch.Tensor   # (I, 1) uniforms: a player mutates below mutate_prob


def draw_generation(gen: torch.Generator, ctx: GameContext, cfg: GAConfig,
                    device=None) -> GenerationDraws:
    """One generation's draws, on ``device`` (the env's by default)."""
    dev = ctx.env.er.device if device is None else device
    i_n = ctx.num_players()
    pa, pb, mix = (torch.rand(shape, generator=gen) for shape in ((1,), (1,), (i_n, 1)))
    mut = draw_gammas(gen, ctx.joint_shape(), dev)
    do_mut = torch.rand((i_n, 1), generator=gen)
    return GenerationDraws(to_device(pa, dev), to_device(pb, dev), to_device(mix, dev), mut,
                           to_device(do_mut, dev))


def generation(pop: torch.Tensor, fit: torch.Tensor, draws: GenerationDraws, obj,
               cfg: GAConfig):
    """One steady-state generation: (pop, fit) -> (pop, fit)."""
    # Genitor rank-based selection: linear bias toward better ranks
    order = torch.argsort(fit, stable=True)  # ascending (minimization)
    ranks = torch.argsort(order, stable=True)
    p_sel = (cfg.population - ranks).float()
    p_sel = p_sel / torch.sum(p_sel)
    pa = pop.index_select(0, choice(p_sel, draws.pa))[0]
    pb = pop.index_select(0, choice(p_sel, draws.pb))[0]
    # player-wise arithmetic crossover ((I, 1) broadcasts over a routed
    # joint's source axis: a player's whole routing matrix is one gene)
    child = draws.mix * pa + (1 - draws.mix) * pb
    # Dirichlet mutation on a random subset of players
    mut = dirichlet(child * cfg.mutate_conc + 0.3, draws.mut)
    child = torch.where(draws.do_mut < cfg.mutate_prob, mut, child)
    child = child / torch.sum(child, dim=-1, keepdim=True)
    cv = obj(child)
    # replace worst
    worst = torch.argmax(fit)
    swap = (torch.arange(cfg.population, device=fit.device) == worst) & (cv < torch.gather(fit, 0, worst[None]))
    pop = torch.where(swap.reshape((-1,) + (1,) * (pop.ndim - 1)), child, pop)
    fit = torch.where(swap, cv, fit)
    return pop, fit


class EpochDraws(NamedTuple):
    """The draws of one solve."""
    pop: torch.Tensor        # (population - 1, *joint) Dirichlet(1) members
    gens: GenerationDraws    # each field with a leading (generations,) axis


def draw_epoch(gen: torch.Generator, ctx: GameContext, cfg: GAConfig, device) -> EpochDraws:
    """Every draw of a solve, in order, on ``device``: the initial population
    beside the uniform split, then each generation's."""
    pop = torch._sample_dirichlet(torch.ones((cfg.population,) + ctx.joint_shape()),
                                  generator=gen)
    pop = to_device(pop[1:], device)
    gens = [draw_generation(gen, ctx, cfg, "cpu") for _ in range(cfg.generations)]
    return EpochDraws(pop, stack_draws(gens, device))


def solve_drawn(draws: EpochDraws, ctx: GameContext, peak_state: torch.Tensor,
                cfg: GAConfig = GAConfig()) -> SolveResult:
    """The solve from ``draw_epoch``'s draws."""
    def obj(f):
        return cloud_objective(ctx, f, peak_state)

    f0 = uniform_fractions(ctx)
    pop = torch.cat([f0[None], draws.pop])  # seeded with the uniform split
    fit = vmap(obj)(pop)
    hist = []
    for g in range(cfg.generations):
        pop, fit = generation(pop, fit, tree_map(lambda x: x[g], draws.gens), obj, cfg)
        hist.append(torch.min(fit))
    best = pop.index_select(0, torch.argmin(fit)[None])[0]
    return SolveResult(best, {"history": torch.stack(hist), "best": torch.min(fit)})


def solve_epoch(gen: torch.Generator, ctx: GameContext, peak_state: torch.Tensor,
                cfg: GAConfig = GAConfig()) -> SolveResult:
    return solve_drawn(draw_epoch(gen, ctx, cfg, ctx.env.er.device), ctx, peak_state, cfg)
