"""Training core: optimizer, TrainState, the train step, evaluation.

Port of ``fewshot/training.py``.  A step samples
its episodes on the device (``data.episodes.sample_episode``), runs the
forward and backward (the kernels' autograd Functions: the LSTM's and the
head+CE's under ``cell="pallas"``, the transformer's attention under
``prefix_flash``), divides the gradients (CE sums) by the token count, and
applies the optax chain of the JAX package by hand.  The step and its
phases are profiler spans (``utils.metrics.span``): ``train.step`` holding
``episodes.draw``, ``model.forward``, ``model.backward``, ``optim.apply``.
The optimizer chain:

* ``clip_by_global_norm``: scale only when the norm reaches the maximum,
  and then by max / norm (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
  and always scales, so it is not used);
* Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), AdamW when
  ``weight_decay > 0``, or SGD;
* the learning rate, or ``linear_schedule(0, lr, warmup_steps)`` read at
  the count before the update (the first warm-up step has lr 0).

Parameters (0-d ones included: the cache head's ``cache_gate.b`` and
``cache_prior.log_s``) and optimizer moments are updated in place
(PyTorch tensors are mutable; the JAX step returns new arrays).  Nothing in a step reads a value
back to the host, so a later change can capture it in a CUDA graph.

Data parallelism (``mesh``, ``parallel/mesh.py``): each process draws
batch_size / W episodes from its own generator (``mesh.rank_seed``), and
the gradients, CE sum and token count are summed over the processes in one
all-reduce before the division by the count, as JAX's shard_map step psums
them.  Every function of a mesh takes it as ``mesh=`` (the CLI passes the
process group's, ``make_mesh()``); a world of one draws and computes what
the single process does, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fewshot_torch.data.episodes import (CorpusOnDevice, gather_episode,
                                         sample_episode, sample_lm_batch)
from fewshot_torch.device import resolve_device
from fewshot_torch.models import lm as lm_mod
from fewshot_torch.parallel.mesh import (Mesh, local_batch, rank_seed,
                                         shard_step, sum_over)
from fewshot_torch.utils.metrics import span

B1, B2, EPS = 0.9, 0.999, 1e-8


class OptState(NamedTuple):
    """The optimizer's state: the update count (an int64 scalar on the
    parameters' device, read by the bias correction and the schedule) and,
    for Adam, the moments by parameter name (``lstm.0.wx`` ...)."""
    count: torch.Tensor
    mu: dict
    nu: dict


class TrainState(NamedTuple):
    params: lm_mod.LM
    opt_state: OptState
    step: int
    gen: torch.Generator    # on the parameters' device; feeds the sampler


class Optimizer:
    """The JAX package's ``make_optimizer`` chain as in-place updates."""

    def __init__(self, cfg):
        self.kind = cfg.optimizer
        self.lr = cfg.lr
        self.warmup = cfg.warmup_steps
        self.weight_decay = cfg.weight_decay
        self.clip = cfg.grad_clip

    def init(self, params) -> OptState:
        named = dict(params.named_parameters())
        dev = next(iter(named.values())).device
        zeros = ({k: torch.zeros_like(p) for k, p in named.items()}
                 if self.kind == "adam" else {})
        return OptState(torch.zeros((), dtype=torch.int64, device=dev),
                        zeros, {k: v.clone() for k, v in zeros.items()})

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """lr at the update count (linear_schedule(0, lr, warmup) when
        warming up), fp32."""
        if self.warmup <= 0:
            return torch.full((), self.lr, device=count.device)
        done = count.clamp(0, self.warmup).float()
        frac = 1.0 - done / self.warmup
        return (0.0 - self.lr) * frac + self.lr

    @torch.no_grad()
    def update_(self, grads: dict, state: OptState, params,
                g_norm: torch.Tensor) -> None:
        """Apply one update to params and state in place.  grads: the
        normalized gradients by parameter name; g_norm their global norm."""
        if self.clip > 0:
            keep = g_norm < self.clip
            grads = {k: torch.where(keep, g, (g / g_norm) * self.clip)
                     for k, g in grads.items()}
        step = -self.learning_rate(state.count)
        count = state.count + 1
        if self.kind == "adam":     # bias corrections, fp32 as in optax
            fix1 = 1.0 - torch.pow(B1, count.float())
            fix2 = 1.0 - torch.pow(B2, count.float())
        for name, p in params.named_parameters():
            g = grads[name]
            if self.kind == "adam":
                mu, nu = state.mu[name], state.nu[name]
                mu.copy_((1.0 - B1) * g + B1 * mu)
                nu.copy_((1.0 - B2) * (g * g) + B2 * nu)
                u = (mu / fix1) / (torch.sqrt(nu / fix2) + EPS)
                if self.weight_decay > 0:
                    u = u + self.weight_decay * p
            else:
                u = g
            p.add_(step * u)
        state.count.copy_(count)


def make_optimizer(cfg) -> Optimizer:
    return Optimizer(cfg)


def _seeds(seed: int) -> tuple[int, int]:
    """Two independent seeds (weights, sampler) from one."""
    a, b = np.random.SeedSequence(seed).spawn(2)
    return int(a.generate_state(1)[0]), int(b.generate_state(1)[0])


def init_train_state(cfg, vocab_size: int, seed: int | None = None,
                     device: torch.device | str | None = None,
                     mesh: Mesh | None = None) -> TrainState:
    """Random parameters, a fresh optimizer state and a sampler generator
    on `device` (cuda unless the caller names the CPU).  The parameters
    are the same on every rank of `mesh`; the generator is the rank's
    (``mesh.rank_seed``: a world of one keeps the single-process one)."""
    dev = resolve_device(device)
    s_init, s_run = _seeds(cfg.seed if seed is None else seed)
    params = lm_mod.init_lm(cfg, vocab_size,
                            torch.Generator().manual_seed(s_init), dev)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(s_run, mesh))
    return TrainState(params, make_optimizer(cfg).init(params), 0, gen)


def _loss_stats(params, cfg, data: CorpusOnDevice, split_artists, gen,
                batch_size: int, train: bool = False):
    """Sample a batch/episodes on the device and return (ce_sum, count).

    train=False flags eval_mode downstream (the forward-only fused stack).
    In training with cfg.dropout > 0 the dropout masks are drawn from gen
    after the episodes, so the generator's state (the checkpoint's
    rng.npz) carries both streams."""
    drop = gen if (train and cfg.dropout > 0) else None
    if cfg.task == "episodic":
        with span("episodes.draw"):
            ep = sample_episode(gen, data, split_artists, batch_size,
                                k=cfg.support_size, q=cfg.query_size)
        with span("model.forward"):
            return lm_mod.episodic_nll_stats(params, ep, cfg,
                                             eval_mode=not train, drop=drop)
    with span("episodes.draw"):
        tokens, lengths = sample_lm_batch(gen, data, split_artists,
                                          batch_size)
    with span("model.forward"):
        return lm_mod.lm_nll_stats(params, tokens, lengths, cfg,
                                   eval_mode=not train, drop=drop)


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def _make_apply(cfg, opt: Optimizer):
    """The grad-normalize + optimizer update half of a train step.  Raises
    for model='moonlight', which samples and evaluates only (no train step
    of it is held against a reference)."""
    if cfg.model == "moonlight":
        raise ValueError("model='moonlight' has no train step: it samples "
                         "and evaluates only")

    def apply(state: TrainState, grads: dict, total, count):
        with span("optim.apply"):
            # grads are CE sums; normalize by the token count
            inv = 1.0 / count.clamp_min(1.0)
            grads = {k: g * inv for k, g in grads.items()}
            g_norm = global_norm(grads)
            opt.update_(grads, state.opt_state, state.params, g_norm)
            metrics = {"loss": total.detach() * inv, "tokens": count,
                       "grad_norm": g_norm}
        return state._replace(step=state.step + 1), metrics
    return apply


def _grads(params, loss_fn):
    """(grads by parameter name, total, count) of loss_fn() = (total,
    count), total differentiated with respect to params."""
    for p in params.parameters():
        p.grad = None
    total, count = loss_fn()
    with span("model.backward"):
        total.backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return grads, total, count


def make_train_step(cfg, data: CorpusOnDevice, split_artists,
                    mesh: Mesh | None = None):
    """The train step: state -> (state, metrics).  `split_artists` is the
    train split's artist ids (or the song pool for task="lm") on the
    corpus device.  Under a mesh each rank samples batch_size / W episodes
    and the sums are all-reduced."""
    apply = _make_apply(cfg, make_optimizer(cfg))
    rows = local_batch(cfg.batch_size, mesh)

    def local_grads(state: TrainState):
        return _grads(state.params, lambda: _loss_stats(
            state.params, cfg, data, split_artists, state.gen, rows,
            train=True))
    sharded = shard_step(mesh, local_grads)

    def train_step(state: TrainState):
        with span("train.step"):
            return apply(state, *sharded(state))
    return train_step


def make_fed_train_step(cfg, mesh: Mesh | None = None):
    """The train step on an episode given as an argument:
    (state, episode) -> (state, metrics).  Under a mesh the episode is
    this rank's rows of the batch (``HostEpisodePipeline(rank=, world=)``)
    and the sums are all-reduced."""
    apply = _make_apply(cfg, make_optimizer(cfg))

    def local_grads(state: TrainState, ep):
        drop = state.gen if cfg.dropout > 0 else None

        def loss():
            with span("model.forward"):
                return lm_mod.episodic_nll_stats(state.params, ep, cfg,
                                                 drop=drop)
        return _grads(state.params, loss)
    sharded = shard_step(mesh, local_grads)

    def train_step(state: TrainState, ep):
        with span("train.step"):
            return apply(state, *sharded(state, ep))
    return train_step


def make_multi_step(train_step, k: int):
    """k train steps per call, returning the last step's metrics: the same
    trajectory as calling train_step k times (a Python loop; capturing the
    chunk in a CUDA graph is later work)."""
    if k <= 1:
        return train_step

    def multi(state: TrainState):
        for _ in range(k):
            state, metrics = train_step(state)
        return state, metrics
    return multi


def make_eval_step(cfg, data: CorpusOnDevice, split_artists,
                   mesh: Mesh | None = None):
    """Eval on one batch sampled on the device: (params, gen) -> (ce_sum,
    count), forward only (eval_mode: no aux terms, no grads).  Under a
    mesh each rank evaluates batch_size / W episodes from its own
    generator and the pair is all-reduced."""
    rows = local_batch(cfg.batch_size, mesh)

    def eval_step(params, gen: torch.Generator):
        with torch.no_grad():
            pair = _loss_stats(params, cfg, data, split_artists, gen, rows)
        return sum_over(mesh, pair)
    return eval_step


def make_fed_eval_step(cfg):
    """Eval on a fed episode: (params, episode) -> (ce_sum, count)."""
    def eval_step(params, ep):
        with torch.no_grad():
            return lm_mod.episodic_nll_stats(params, ep, cfg, eval_mode=True)
    return eval_step


def evaluate_fed(cfg, params, pipe, num_episodes: int | None = None,
                 eval_step=None, mesh: Mesh | None = None) -> float:
    """Average NLL/token over episodes drawn from `pipe`, any iterator of
    Episodes (its ``batch`` attribute, else cfg.batch_size, is the episodes
    a draw holds): num_episodes // batch draws, at least one.  Every
    draw's pair is added on the device and one pair is read at the end.
    Under a mesh `pipe` yields this rank's rows of each draw
    (``HostEpisodePipeline(rank=, world=)``) and the pair is summed over
    the ranks (one all-reduce a call)."""
    n = num_episodes if num_episodes is not None else cfg.eval_episodes
    step = eval_step if eval_step is not None else make_fed_eval_step(cfg)
    batch = getattr(pipe, "batch", cfg.batch_size)
    stats = [torch.stack(step(params, next(pipe)))
             for _ in range(max(1, n // batch))]
    pair, = sum_over(mesh, [torch.stack(stats).sum(dim=0)])
    total, count = pair.tolist()
    return total / max(count, 1.0)


def evaluate_episode_set(cfg, params, data: CorpusOnDevice, song_ids,
                         artists, k: int, q: int) -> float:
    """Average query NLL/token over a fixed episode set (``song_ids``
    [N, k+q], ``artists`` [N], as ``data.episodes.load_episode_set`` reads
    them), cfg.batch_size episodes a batch.  Every batch's pair is added on
    the device and one pair is read at the end."""
    step = make_fed_eval_step(cfg)
    b = cfg.batch_size
    stats = [torch.stack(step(params, gather_episode(
        data, song_ids[lo:lo + b], artists[lo:lo + b], k, q)))
        for lo in range(0, len(song_ids), b)]
    total, count = torch.stack(stats).sum(dim=0).tolist()
    return total / max(count, 1.0)


def mean_nll(step, params, gen: torch.Generator, cfg,
             num_episodes: int | None = None) -> float:
    """Average NLL/token of step(params, gen) -> (ce_sum, count) over
    num_episodes // batch_size batches (at least one; cfg.eval_episodes by
    default).  Every batch's pair is added on the device and one pair is
    read at the end."""
    n = num_episodes if num_episodes is not None else cfg.eval_episodes
    stats = [torch.stack(step(params, gen))
             for _ in range(max(1, n // cfg.batch_size))]
    total, count = torch.stack(stats).sum(dim=0).tolist()
    return total / max(count, 1.0)


def evaluate(cfg, params, data: CorpusOnDevice, split_artists,
             gen: torch.Generator, num_episodes: int | None = None,
             mesh: Mesh | None = None) -> float:
    """Average query NLL/token over num_episodes // batch_size batches
    sampled from gen on the corpus device (``mean_nll``); under a mesh,
    gen is the rank's and the batches are split over the ranks."""
    return mean_nll(make_eval_step(cfg, data, split_artists, mesh), params,
                    gen, cfg, num_episodes)
