"""Unigram baselines: the count models the neural ones must beat.

Port of ``fewshot/models/unigram.py``:

* the global unigram: smoothed token frequencies over the train split's
  songs (``fit_global``);
* the episodic unigram: per episode, the support set's counts plus the
  global prior (``prior_strength`` pseudo-counts), a Dirichlet posterior
  (``episodic_nll_stats``).  A model that uses its support set beats this
  floor.

NLL semantics are the neural path's (targets 1..len-1, PAD masked), so the
numbers compare directly.  Under a data mesh the floor's batches are split
over the ranks as ``training.make_eval_step`` splits the model's.
"""

from __future__ import annotations

import torch

from fewshot_torch.data import episodes as eps
from fewshot_torch.data.vocab import PAD
from fewshot_torch.models.lm import shift_targets, support_counts
from fewshot_torch.parallel.mesh import Mesh, local_batch, sum_over
from fewshot_torch.training import mean_nll


def fit_global(songs: torch.Tensor, song_len: torch.Tensor,
               song_pool: torch.Tensor, vocab_size: int,
               alpha: float = 1.0) -> torch.Tensor:
    """Smoothed global log-probs [V] from a split's songs.

    A scatter-add over the pool's target positions: a one-hot count would
    be [pool, L-1, V].  Counts are integers, so the order of the adds does
    not change them."""
    _, targets, mask = shift_targets(songs[song_pool], song_len[song_pool])
    counts = torch.zeros(vocab_size, device=songs.device)
    counts.index_add_(0, targets.reshape(-1), mask.reshape(-1).float())
    counts[PAD] = 0.0
    smoothed = counts + alpha
    return torch.log(smoothed / smoothed.sum())


def episodic_nll_stats(ep, global_log_probs: torch.Tensor, vocab_size: int,
                       prior_strength: float = 50.0):
    """(ce_sum, count) of the per-episode Dirichlet-posterior unigram."""
    sup_counts = support_counts(ep.support, ep.support_len, vocab_size)
    post = sup_counts + torch.exp(global_log_probs)[None] * prior_strength
    log_p = torch.log(post / post.sum(dim=-1, keepdim=True))     # [B, V]
    _, targets, mask = shift_targets(ep.query, ep.query_len)      # [B,Q,L-1]
    b = targets.shape[0]
    tok_lp = log_p.gather(1, targets.reshape(b, -1)).reshape(targets.shape)
    m = mask.float()
    return -(tok_lp * m).sum(), m.sum()


def lm_nll_stats(tokens: torch.Tensor, lengths: torch.Tensor,
                 log_probs: torch.Tensor):
    """(ce_sum, count) of the global unigram on a [B, T] batch."""
    _, targets, mask = shift_targets(tokens, lengths)
    m = mask.float()
    return -(log_probs[targets] * m).sum(), m.sum()


def make_unigram_eval_step(cfg, data, split_artists, vocab_size: int,
                           mesh: Mesh | None = None):
    """(glp, gen) -> (ce_sum, count) over one episodic batch sampled on the
    corpus device from the generator gen.  Under a mesh each rank draws
    batch_size / W episodes from its own gen and the pair is
    all-reduced."""
    rows = local_batch(cfg.batch_size, mesh)

    def step(glp, gen):
        ep = eps.sample_episode(gen, data, split_artists, rows,
                                k=cfg.support_size, q=cfg.query_size)
        pair = episodic_nll_stats(ep, glp, vocab_size)
        return sum_over(mesh, pair)
    return step


def evaluate_unigram(cfg, corpus, data, split_artists, gen: torch.Generator,
                     num_episodes: int | None = None,
                     mesh: Mesh | None = None) -> float:
    """Average query NLL/token of the episodic unigram over
    num_episodes // batch_size batches (``training.mean_nll``), the global
    prior fitted on the train split."""
    pool = torch.as_tensor(eps.split_song_pool(corpus, "train"),
                           dtype=torch.int64, device=data.songs.device)
    v = len(corpus.vocab)
    glp = fit_global(data.songs, data.song_len, pool, v)
    return mean_nll(make_unigram_eval_step(cfg, data, split_artists, v,
                                           mesh), glp, gen, cfg,
                    num_episodes)
