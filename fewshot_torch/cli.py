"""Training from the command line, on one CUDA card.

Port of ``fewshot/cli.py``'s ``train_main``:

    python -m fewshot_torch.cli train --data <yaml> --model <yaml>
        --task <yaml> [--checkpt_dir DIR] [--set K=V ...]
        [--device cuda|cpu] [--profile_dir DIR] [--debug_nans]
        [--tensorboard]

The step loop samples its episodes on the device, runs ``steps_per_call``
steps per chunk (``training.make_multi_step``), logs loss, episodes/s and
the grad norm every ``log_interval`` steps, the validation NLL every
``eval_interval`` steps, and checkpoints every ``checkpoint_interval``
steps and at the end (``utils/ckpt.py``; a run pointed at a directory with
a checkpoint resumes from its latest step).  ``data_parallel`` on one card
is a mesh of one device; ``pipeline: host`` is not ported yet.  The run is
on ``cuda`` unless ``--device cpu`` is given, and raises without a card.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

from fewshot_torch import training
from fewshot_torch.config import add_config_flags, load_config, \
    parse_overrides
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.corpus import PackedCorpus, support_coverage_estimate
from fewshot_torch.device import resolve_device
from fewshot_torch.utils.ckpt import hparams_of, recover_or_init, \
    save_checkpoint
from fewshot_torch.utils.metrics import MetricsLogger, Throughput


def _setup(argv, extra_flags=None):
    """Parse the shared flags, load the config and the packed corpus."""
    parser = argparse.ArgumentParser()
    add_config_flags(parser)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    if extra_flags:
        extra_flags(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args.data, args.model, args.task,
                      parse_overrides(args.set))
    corpus_dir = Path(cfg.corpus_dir)
    if not (corpus_dir / "corpus.npz").exists():
        sys.exit(f"no packed corpus at {corpus_dir} — run "
                 f"scripts/prepare_data.py first (see README)")
    corpus = PackedCorpus.load(corpus_dir)
    if corpus.max_len != cfg.max_len:
        print(f"warning: corpus max_len={corpus.max_len} != config "
              f"max_len={cfg.max_len}; the packed corpus wins "
              f"(re-run scripts/prepare_data.py to change it)", flush=True)
    if corpus.vocab is not None and len(corpus.vocab) > cfg.vocab_size:
        sys.exit(f"corpus vocab ({len(corpus.vocab)}) exceeds config "
                 f"vocab_size ({cfg.vocab_size}); re-pack or raise the cap")
    return args, cfg, corpus


def _split_arg(cfg, corpus, split: str, device) -> torch.Tensor:
    """The sampler's index tensor: artist ids (episodic) or song pool
    (lm), on the corpus device."""
    ids = (corpus.splits[split] if cfg.task == "episodic"
           else eps.split_song_pool(corpus, split))
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def _warn_starvation(cfg, corpus) -> None:
    """The cache head without a starvation fix, where the support songs
    already cover nearly all query tokens: the gate routes to the count
    posterior, the LM branch's gradient is scaled to ~1 % and training
    freezes at the unigram floor.  Keyed on the measured coverage."""
    if not (cfg.support_cache and cfg.cache_lm_aux == 0
            and cfg.cache_resp_floor == 0 and corpus.vocab is not None):
        return
    cov = support_coverage_estimate(corpus, cfg.support_size)
    if cov >= 0.95:
        print(f"warning: support_cache with measured support coverage "
              f"{cov:.3f} of query tokens (V={len(corpus.vocab)}) and no "
              f"starvation fix risks mixture gradient starvation (training "
              f"freezes at the unigram floor) — set --set "
              f"cache_resp_floor=0.25 (recommended; exactly inert where "
              f"the mixture is healthy) or cache_lm_aux=1.0", flush=True)


def _checked(train_step):
    """train_step that raises on the first non-finite loss or grad norm
    (each step waits for the device)."""
    def step(state):
        state, metrics = train_step(state)
        for k in ("loss", "grad_norm"):
            if not math.isfinite(float(metrics[k])):
                raise FloatingPointError(
                    f"non-finite {k} {float(metrics[k])} at step "
                    f"{state.step}")
        return state, metrics
    return step


def train_main(argv=None) -> None:
    def flags(p):
        p.add_argument("--profile_dir", type=str, default=None,
                       help="write a torch.profiler trace of steps 10-20 "
                            "into this dir (Chrome trace format)")
        p.add_argument("--debug_nans", action="store_true",
                       help="fail on the first non-finite loss or grad "
                            "norm")
        p.add_argument("--tensorboard", action="store_true",
                       help="also write TensorBoard scalars under "
                            "<checkpt_dir>/tb where tensorboard is "
                            "installed")
    args, cfg, corpus = _setup(argv, flags)
    device = resolve_device(args.device)
    _warn_starvation(cfg, corpus)
    if cfg.pipeline == "host":
        raise NotImplementedError(
            "pipeline: host (the host episode pipeline and the native "
            "tokenizer) is not ported yet (ROADMAP.md, queue 1); use "
            "pipeline: device")
    vocab_hash = corpus.vocab.content_hash() if corpus.vocab else ""
    # the whole corpus lives on the device; data_parallel on one card is a
    # mesh of one device
    data = eps.put_corpus(corpus, device)
    train_split = _split_arg(cfg, corpus, "train", device)
    val_split = _split_arg(cfg, corpus, "val", device)

    state = training.init_train_state(cfg, len(corpus.vocab), device=device)
    state, restored = recover_or_init(args.checkpt_dir, state, vocab_hash,
                                      hparams=hparams_of(cfg))
    start_step = int(state.step)
    if restored:
        print(f"restored checkpoint at step {start_step}", flush=True)

    train_step = training.make_train_step(cfg, data, train_split)
    if args.debug_nans:
        train_step = _checked(train_step)
    logger = MetricsLogger(args.checkpt_dir, stdout=True,
                           tensorboard=args.tensorboard)
    tput = Throughput()
    tput.start()
    # steps_per_call steps a chunk; config validation puts every log, eval
    # and checkpoint boundary on a chunk edge.  Profiling brackets step
    # indices, so it runs one step a chunk.
    spc = 1 if args.profile_dir else cfg.steps_per_call
    if start_step % spc:
        # a checkpoint written under another steps_per_call would make the
        # chunked range miss every boundary and stop short of max_steps
        sys.exit(f"restored step {start_step} is not a multiple of "
                 f"steps_per_call ({spc}) — resume with --set "
                 f"steps_per_call=<divisor of {start_step}> (e.g. 1) or "
                 f"the value the checkpoint was trained with")
    chunked = training.make_multi_step(train_step, spc)
    prof = None
    for step in range(start_step + spc, cfg.max_steps + 1, spc):
        if args.profile_dir and step == 10:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if device.type == "cuda" else [])])
            prof.start()
        state, metrics = chunked(state)
        if prof is not None and step == 20:
            float(metrics["loss"])                 # wait for the device
            prof.stop()
            out = Path(args.profile_dir)
            out.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(out / "trace.json"))
            prof = None
            print(f"profile trace written to {args.profile_dir}", flush=True)
        tput.add(cfg.batch_size * spc)
        if step % cfg.log_interval == 0 or step == cfg.max_steps:
            loss = float(metrics["loss"])          # waits for the device
            rate = tput.rate()
            logger.log(step, loss=loss, episodes_per_sec=rate,
                       tokens_per_sec=rate * float(metrics["tokens"])
                       / cfg.batch_size,
                       grad_norm=float(metrics["grad_norm"]))
            tput.start()
        if cfg.eval_interval and step % cfg.eval_interval == 0:
            gen = torch.Generator(device=device).manual_seed(cfg.seed + step)
            nll = training.evaluate(cfg, state.params, data, val_split, gen)
            logger.log(step, val_nll=nll)
        if args.checkpt_dir and cfg.checkpoint_interval and \
                step % cfg.checkpoint_interval == 0:
            save_checkpoint(args.checkpt_dir, state, vocab_hash,
                            hparams=hparams_of(cfg))
    if args.checkpt_dir:
        save_checkpoint(args.checkpt_dir, state, vocab_hash,
                        hparams=hparams_of(cfg))
    logger.close()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] != ["train"]:
        sys.exit("usage: python -m fewshot_torch.cli train [flags]")
    train_main(argv[1:])


if __name__ == "__main__":
    main()
