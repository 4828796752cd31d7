"""FewShotModel: the reference's object contract over the functional core.

Port of ``fewshot/models/base.py``.  The reference's ``BaseModel`` offers
``train``, ``eval``, ``sample``, ``save`` and ``recover_or_init``; the port's
core is functions over an ``LM`` and a ``TrainState`` (``models/lm.py``,
``training.py``, ``utils/ckpt.py``).  This class holds the one mutable
``TrainState`` and forwards each method to those functions, so everything
it does can also be done through them.  It runs on ``cuda`` unless
``device="cpu"`` is given, and raises without a card.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fewshot_torch import sampling as sampling_mod
from fewshot_torch import training
from fewshot_torch.data import episodes as eps
from fewshot_torch.device import resolve_device
from fewshot_torch.models import lm as lm_mod
from fewshot_torch.utils import ckpt


class FewShotModel:
    """One model and its optimizer over one packed corpus."""

    def __init__(self, cfg, corpus, seed: int | None = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.corpus = corpus
        self.device = resolve_device(device)
        self.data = eps.put_corpus(corpus, self.device)
        self.state = training.init_train_state(cfg, len(corpus.vocab),
                                               seed=seed, device=self.device)
        self._train_step = None
        self._token_masks = sampling_mod.grammar_masks(cfg, corpus,
                                                        self.device)

    def _vocab_hash(self) -> str:
        return self.corpus.vocab.content_hash() if self.corpus.vocab else ""

    def _split(self, name: str) -> torch.Tensor:
        ids = (self.corpus.splits[name] if self.cfg.task == "episodic"
               else eps.split_song_pool(self.corpus, name))
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=self.device)

    # -- training -----------------------------------------------------------

    def train(self, steps: int = 1) -> float:
        """Run `steps` train steps (episode sampling included); returns the
        last step's loss."""
        if self._train_step is None:
            self._train_step = training.make_train_step(
                self.cfg, self.data, self._split("train"))
        loss = float("nan")
        for _ in range(steps):
            self.state, metrics = self._train_step(self.state)
            loss = metrics["loss"]
        return float(loss)

    @property
    def step(self) -> int:
        return int(self.state.step)

    # -- evaluation ---------------------------------------------------------

    def eval(self, episode: eps.Episode | None = None, split: str = "val",
             num_episodes: int | None = None) -> float:
        """NLL/token: of one episode if given, else averaged over episodes
        of a split (drawn from a generator seeded with cfg.seed)."""
        if episode is not None:
            with torch.no_grad():
                return float(lm_mod.episodic_nll(self.state.params, episode,
                                                 self.cfg))
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return training.evaluate(self.cfg, self.state.params, self.data,
                                 self._split(split), gen,
                                 num_episodes=num_episodes)

    # -- generation ---------------------------------------------------------

    def sample(self, support: torch.Tensor, support_len: torch.Tensor,
               n_tokens: int | None = None, seed: int = 0) -> np.ndarray:
        """Support-conditioned continuations -> token ids [B, n]; row i
        draws from ``sampling.row_generator(seed + i, 1)``."""
        support = torch.as_tensor(support, device=self.device).long()
        support_len = torch.as_tensor(support_len,
                                      device=self.device).long()
        gens = [sampling_mod.row_generator(seed + i, 1, self.device)
                for i in range(support.shape[0])]
        toks = sampling_mod.generate(self.state.params, support, support_len,
                                     gens, self.cfg, n_tokens=n_tokens,
                                     token_masks=self._token_masks)
        return toks.cpu().numpy()

    def sample_artist(self, split: str = "test", num: int = 1,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Draw support sets from a split and continue them: (tokens [num,
        n], artist ids [num])."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        artists = torch.as_tensor(np.asarray(self.corpus.splits[split]),
                                  dtype=torch.int64, device=self.device)
        ep = eps.sample_episode(gen, self.data, artists, num,
                                k=self.cfg.support_size,
                                q=self.cfg.query_size)
        return (self.sample(ep.support, ep.support_len, seed=seed + 1),
                ep.artist.cpu().numpy())

    # -- persistence ---------------------------------------------------------

    def save(self, ckpt_dir: str | Path) -> None:
        ckpt.save_checkpoint(ckpt_dir, self.state, self._vocab_hash(),
                             hparams=ckpt.hparams_of(self.cfg))

    def recover_or_init(self, ckpt_dir: str | Path | None) -> bool:
        """Restore the latest checkpoint in ckpt_dir if there is one; True
        if one was restored."""
        self.state, restored = ckpt.recover_or_init(
            ckpt_dir, self.state, self._vocab_hash(),
            hparams=ckpt.hparams_of(self.cfg))
        return restored
