"""The port's command line: prepare, train, evaluate, sample, make-eval-set.

Port of ``fewshot/cli.py`` (``train_main``, ``evaluate_main``,
``sample_main``) and of the offline scripts ``scripts/prepare_data.py`` and
``scripts/make_eval_set.py``:

    python -m fewshot_torch.cli prepare --out DIR (--synthetic [--dataset
        lyrics|midi] | --lyrics_csv CSV | --midi_root DIR) [--artists N]
        [--songs N] [--vocab_size N] [--max_len N] [--bpe_merges N]
        [--notes_lo N] [--notes_hi N] [--seed N]
    python -m fewshot_torch.cli train --data <yaml> --model <yaml>
        --task <yaml> [--checkpt_dir DIR] [--set K=V ...]
        [--device cuda|cpu] [--profile_dir DIR] [--debug_nans]
        [--tensorboard]
    python -m fewshot_torch.cli evaluate <the same config flags>
        [--split S] [--episodes N] [--baseline unigram] [--per_artist]
        [--eval_set NPZ [--also_split_eval]]
    python -m fewshot_torch.cli sample <the same config flags> [--out DIR]
        [--num N] [--split S]
    python -m fewshot_torch.cli make-eval-set --corpus DIR --out NPZ
        [--split S] [--episodes N] [--k K] [--q Q] [--seed N]

``evaluate`` and ``sample`` print the JAX package's lines, so a script that
parses one package's output parses the other's.  ``sample`` writes one
``.txt`` per continuation for lyrics and one ``.mid`` for MIDI (BPE tokens
expanded first; MIDI without merges is sampled under the event grammar's
masks).  The corpora, fixed episode sets and ``.mid`` files are the JAX
package's byte for byte for the same seeds.

The step loop samples its episodes on the device, runs ``steps_per_call``
steps per chunk (``training.make_multi_step``), logs loss, episodes/s and
the grad norm every ``log_interval`` steps, the validation NLL every
``eval_interval`` steps, and checkpoints every ``checkpoint_interval``
steps and at the end (``utils/ckpt.py``; a run pointed at a directory with
a checkpoint resumes from its latest step).  ``pipeline: host`` (task
episodic only) streams the episodes from host RAM instead
(``data/host_pipeline.py``), one step a call, and evaluates on a val
pipeline seeded ``seed + 1``; a resumed host run seeds its train pipeline
with ``seed + start_step`` so that it draws fresh episodes, as the JAX
package does, and so differs from an unbroken run by design.  Every
command that runs the model is on ``cuda`` unless ``--device cpu`` is
given, and raises without a card.

Several processes, one per card (``parallel/distributed.py``): run
process i of N with ``FEWSHOT_COORDINATOR=<host>:<port>
FEWSHOT_NUM_PROCESSES=N FEWSHOT_PROCESS_ID=i`` set, e.g. on one host

    for i in 0 1 2 3; do FEWSHOT_COORDINATOR=127.0.0.1:29500 \
        FEWSHOT_NUM_PROCESSES=4 FEWSHOT_PROCESS_ID=$i \
        python -m fewshot_torch.cli train ... & done; wait

Under ``data_parallel`` each process then trains and evaluates on
batch_size / N of the episodes (the sums all-reduced over NCCL, or gloo
with ``--device cpu``); only process 0 logs, prints and writes files.
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from fewshot_torch import sampling as sampling_mod
from fewshot_torch import training
from fewshot_torch.config import add_config_flags, load_config, \
    parse_overrides
from fewshot_torch.data import episodes as eps
from fewshot_torch.data import midi as midi_mod
from fewshot_torch.data.corpus import (PackedCorpus, build_lyrics_corpus,
                                       build_midi_corpus,
                                       support_coverage_estimate)
from fewshot_torch.data.lyrics import detokenize
from fewshot_torch.data.synthetic import (generate_lyrics_csv,
                                          generate_midi_corpus)
from fewshot_torch.data.host_pipeline import HostEpisodePipeline
from fewshot_torch.models.unigram import evaluate_unigram
from fewshot_torch.parallel.distributed import (is_primary, maybe_initialize,
                                                process_device)
from fewshot_torch.parallel.mesh import make_mesh, rank_seed
from fewshot_torch.utils.ckpt import hparams_of, recover_or_init, \
    restore_params, save_checkpoint
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
    maybe_initialize(args.device)
    cfg = load_config(args.data, args.model, args.task,
                      parse_overrides(args.set))
    corpus_dir = Path(cfg.corpus_dir)
    if not (corpus_dir / "corpus.npz").exists():
        sys.exit(f"no packed corpus at {corpus_dir} — run "
                 f"python -m fewshot_torch.cli prepare first (see README)")
    corpus = PackedCorpus.load(corpus_dir)
    if corpus.max_len != cfg.max_len and is_primary():
        print(f"warning: corpus max_len={corpus.max_len} != config "
              f"max_len={cfg.max_len}; the packed corpus wins "
              f"(re-run prepare to change it)", flush=True)
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
    def step(state, *ep):
        state, metrics = train_step(state, *ep)
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
    device = process_device(args.device)
    if is_primary():
        _warn_starvation(cfg, corpus)
    vocab_hash = corpus.vocab.content_hash() if corpus.vocab else ""
    if cfg.pipeline == "host" and cfg.task != "episodic":
        sys.exit("pipeline: host supports only task: episodic — use "
                 "pipeline: device for plain-LM training (task: lm)")
    host_mode = cfg.pipeline == "host"
    mesh = make_mesh() if cfg.data_parallel else None
    if not host_mode:
        # device pipeline: the whole corpus lives on each process's card
        data = eps.put_corpus(corpus, device)
        train_split = _split_arg(cfg, corpus, "train", device)
        val_split = _split_arg(cfg, corpus, "val", device)

    state = training.init_train_state(cfg, len(corpus.vocab), device=device,
                                      mesh=mesh)
    state, restored = recover_or_init(args.checkpt_dir, state, vocab_hash,
                                      hparams=hparams_of(cfg), mesh=mesh)
    start_step = int(state.step)
    if restored and is_primary():
        print(f"restored checkpoint at step {start_step}", flush=True)

    pipe = val_pipe = None
    if host_mode:
        # the restored step folds into the seed, so that a resumed run
        # draws fresh episodes instead of the ones already trained on
        pipe = HostEpisodePipeline(
            corpus, "train", cfg.batch_size, cfg.support_size,
            cfg.query_size, seed=cfg.seed + start_step, device=device,
            rank=mesh.rank if mesh else 0, world=mesh.world if mesh else 1)
        train_step = training.make_fed_train_step(cfg, mesh=mesh)
        if cfg.eval_interval:
            val_pipe = HostEpisodePipeline(
                corpus, "val", cfg.batch_size, cfg.support_size,
                cfg.query_size, seed=cfg.seed + 1, prefetch=1, device=device,
                rank=mesh.rank if mesh else 0,
                world=mesh.world if mesh else 1)
    else:
        train_step = training.make_train_step(cfg, data, train_split,
                                              mesh=mesh)
    if args.debug_nans:
        train_step = _checked(train_step)
    logger = MetricsLogger(args.checkpt_dir if is_primary() else None,
                           stdout=is_primary(),
                           tensorboard=args.tensorboard)
    tput = Throughput()
    tput.start()
    # steps_per_call steps a chunk; config validation puts every log, eval
    # and checkpoint boundary on a chunk edge.  The host pipeline feeds one
    # episode a call, and profiling brackets step indices, so both run one
    # step a chunk.
    spc = 1 if (host_mode or args.profile_dir) else cfg.steps_per_call
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
        state, metrics = (train_step(state, next(pipe)) if pipe is not None
                          else chunked(state))
        if prof is not None and step == 20:
            float(metrics["loss"])                 # wait for the device
            prof.stop()
            out = Path(args.profile_dir)
            out.mkdir(parents=True, exist_ok=True)
            if is_primary():
                prof.export_chrome_trace(str(out / "trace.json"))
                print(f"profile trace written to {args.profile_dir}",
                      flush=True)
            prof = None
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
            if val_pipe is not None:
                nll = training.evaluate_fed(cfg, state.params, val_pipe,
                                            mesh=mesh)
            else:
                gen = torch.Generator(device=device).manual_seed(
                    rank_seed(cfg.seed + step, mesh))
                nll = training.evaluate(cfg, state.params, data, val_split,
                                        gen, mesh=mesh)
            logger.log(step, val_nll=nll)
        if args.checkpt_dir and cfg.checkpoint_interval and \
                step % cfg.checkpoint_interval == 0:
            save_checkpoint(args.checkpt_dir, state, vocab_hash,
                            hparams=hparams_of(cfg), mesh=mesh)
    for p in (pipe, val_pipe):
        if p is not None:
            p.close()
    if args.checkpt_dir:
        save_checkpoint(args.checkpt_dir, state, vocab_hash,
                        hparams=hparams_of(cfg), mesh=mesh)
    logger.close()


def _restore(args, cfg, corpus, device):
    """The parameters to evaluate or sample: the latest checkpoint's when
    --checkpt_dir is given (none there exits), else the config's
    initialization.  Only the parameters are read, so a checkpoint
    written by any number of processes serves."""
    if not args.checkpt_dir:
        return training.init_train_state(cfg, len(corpus.vocab),
                                         device=device).params
    params = restore_params(
        args.checkpt_dir, device,
        corpus.vocab.content_hash() if corpus.vocab else "", hparams_of(cfg))
    if params is None:
        sys.exit(f"no checkpoint found in {args.checkpt_dir}")
    return params


def _print_base_token_nll(corpus, split: str, nll: float, prefix: str,
                          song_ids=None) -> None:
    """An NLL per BPE token is not comparable with one per base token:
    print it rescaled by the compression ratio, over the split's song pool
    or over the songs scored."""
    if not (corpus.merges and corpus.base_song_len is not None):
        return
    ratio = eps.base_token_ratio(corpus, split, song_ids=song_ids)
    scope = "set" if song_ids is not None else "split"
    print(f"{prefix}_nll_per_base_token={nll * ratio:.6f} "
          f"({scope} compression ratio {ratio:.3f})", flush=True)


def evaluate_main(argv=None) -> None:
    def flags(p):
        p.add_argument("--split", default="test",
                       choices=("train", "val", "test"))
        p.add_argument("--episodes", type=int, default=None)
        p.add_argument("--baseline", default=None, choices=("unigram",),
                       help="evaluate a non-neural baseline instead")
        p.add_argument("--per_artist", action="store_true",
                       help="also print the NLL of each artist")
        p.add_argument("--eval_set", type=str, default=None,
                       help="score a fixed episode set (npz from "
                            "make-eval-set): the same result across runs, "
                            "batch sizes and packages")
        p.add_argument("--also_split_eval", action="store_true",
                       help="with --eval_set: also run the random-split "
                            "evaluation afterwards")
    args, cfg, corpus = _setup(argv, flags)
    device = process_device(args.device)
    # under several processes each evaluates its share of every batch
    # from its own generator, and the (ce_sum, count) pairs are summed
    mesh = make_mesh() if cfg.data_parallel else None
    data = eps.put_corpus(corpus, device)
    split = _split_arg(cfg, corpus, args.split, device)

    def gen():
        return torch.Generator(device=device).manual_seed(
            rank_seed(cfg.seed, mesh))

    def say(line: str) -> None:
        if is_primary():
            print(line, flush=True)
    if args.baseline == "unigram":
        if cfg.task != "episodic":
            sys.exit("--baseline unigram requires task=episodic (it scores "
                     "support-conditioned episodes)")
        nll = evaluate_unigram(cfg, corpus, data, split, gen(),
                               args.episodes, mesh=mesh)
        say(f"{args.split}_nll_per_token={nll:.6f} (unigram baseline)")
        return
    params = _restore(args, cfg, corpus, device)
    if args.eval_set:
        if cfg.task != "episodic":
            sys.exit("--eval_set requires task=episodic")
        ids, arts, k, q = eps.load_episode_set(args.eval_set)
        if (k, q) != (cfg.support_size, cfg.query_size):
            sys.exit(f"eval set was built for K={k} Q={q}, config has "
                     f"K={cfg.support_size} Q={cfg.query_size}")
        # the fixed set is scored whole on every process
        nll = training.evaluate_episode_set(cfg, params, data, ids, arts, k,
                                            q)
        say(f"eval_set_nll_per_token={nll:.6f} "
            f"({len(ids)} fixed episodes from {args.eval_set})")
        # over the set's own query songs: the set may come from another
        # split than --split
        if is_primary():
            _print_base_token_nll(corpus, args.split, nll, prefix="eval_set",
                                  song_ids=np.asarray(ids)[:, k:].ravel())
        if not args.also_split_eval:
            return          # one invocation, one advertised result
    nll = training.evaluate(cfg, params, data, split, gen(),
                            num_episodes=args.episodes, mesh=mesh)
    say(f"{args.split}_nll_per_token={nll:.6f}")
    if is_primary():
        _print_base_token_nll(corpus, args.split, nll, prefix=args.split)
    if args.per_artist and cfg.task == "episodic":
        # each artist's episodes alone, from the same generator seed
        for a in np.asarray(corpus.splits[args.split]):
            one = torch.tensor([int(a)], dtype=torch.int64, device=device)
            nll = training.evaluate(cfg, params, data, one, gen(),
                                    num_episodes=args.episodes, mesh=mesh)
            name = (corpus.artist_names[int(a)] if corpus.artist_names
                    else str(int(a)))
            say(f"  artist {name}: nll={nll:.4f}")


def sample_main(argv=None) -> None:
    def flags(p):
        p.add_argument("--out", type=str, default="samples",
                       help="output dir for .txt / .mid continuations")
        p.add_argument("--num", type=int, default=4,
                       help="number of continuations")
        p.add_argument("--split", default="test",
                       choices=("train", "val", "test"))
    args, cfg, corpus = _setup(argv, flags)
    # several processes compute the same samples (the same seeds); only
    # process 0 writes them
    device = process_device(args.device)
    data = eps.put_corpus(corpus, device)
    params = _restore(args, cfg, corpus, device)
    artists = torch.as_tensor(np.asarray(corpus.splits[args.split]),
                              dtype=torch.int64, device=device)
    ep = eps.sample_episode(
        torch.Generator(device=device).manual_seed(cfg.seed), data, artists,
        args.num, k=cfg.support_size, q=cfg.query_size)
    gens = [sampling_mod.row_generator(cfg.seed + i, 1, device)
            for i in range(args.num)]
    toks = sampling_mod.generate(
        params, ep.support, ep.support_len, gens, cfg,
        token_masks=sampling_mod.grammar_masks(cfg, corpus, device))
    toks = toks.cpu().numpy()
    if not is_primary():
        return
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(args.num):
        a = int(ep.artist[i])
        artist = corpus.artist_names[a] if corpus.artist_names else str(a)
        words = corpus.decode(toks[i])
        if cfg.dataset == "midi":
            path = out / f"sample_{i:02d}_{artist}.mid"
            midi_mod.write_midi(midi_mod.events_to_notes(words), path)
        else:
            path = out / f"sample_{i:02d}_{artist}.txt"
            path.write_text(detokenize(words) + "\n")
        print(f"wrote {path}", flush=True)


def make_eval_set_main(argv=None) -> None:
    """Freeze N episodes' (artist, songs) of a corpus split into an npz
    that ``evaluate --eval_set`` scores (``scripts/make_eval_set.py``)."""
    p = argparse.ArgumentParser(prog="fewshot_torch.cli make-eval-set")
    p.add_argument("--corpus", required=True)
    p.add_argument("--split", default="test",
                   choices=("train", "val", "test"))
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--q", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    corpus = PackedCorpus.load(args.corpus)
    eps.save_episode_set(args.out, corpus, args.split, args.episodes,
                         args.k, args.q, args.seed)
    print(f"wrote {args.episodes} {args.split} episodes "
          f"(K={args.k}, Q={args.q}) to {args.out}", flush=True)


def prepare_main(argv=None) -> None:
    """Build a packed corpus offline (``scripts/prepare_data.py``): a
    seeded synthetic one, or one from a lyrics CSV or per-artist ``.mid``
    directories, optionally with BPE merges learned at pack time."""
    p = argparse.ArgumentParser(prog="fewshot_torch.cli prepare")
    p.add_argument("--out", required=True, help="packed corpus output dir")
    p.add_argument("--dataset", default="lyrics", choices=("lyrics", "midi"))
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--lyrics_csv", type=str, default=None)
    p.add_argument("--midi_root", type=str, default=None)
    p.add_argument("--artists", type=int, default=24)
    p.add_argument("--songs", type=int, default=16)
    p.add_argument("--vocab_size", type=int, default=5000)
    p.add_argument("--max_len", type=int, default=256,
                   help="0: the longest song + framing, rounded up to 8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bpe_merges", type=int, default=0,
                   help="learn N byte-pair merges at pack time")
    p.add_argument("--notes_lo", type=int, default=24,
                   help="synthetic MIDI: fewest notes a song")
    p.add_argument("--notes_hi", type=int, default=48,
                   help="synthetic MIDI: most notes a song, exclusive")
    args = p.parse_args(argv)
    if args.lyrics_csv:
        corpus = build_lyrics_corpus(args.lyrics_csv, args.out,
                                     args.vocab_size, args.max_len, args.seed,
                                     args.bpe_merges)
    elif args.midi_root:
        corpus = build_midi_corpus(args.midi_root, args.out, args.max_len,
                                   args.seed, args.bpe_merges)
    elif args.synthetic and args.dataset == "lyrics":
        with tempfile.TemporaryDirectory() as tmp:
            csv_path = Path(tmp) / "lyrics.csv"
            generate_lyrics_csv(csv_path, args.artists, args.songs, args.seed)
            corpus = build_lyrics_corpus(csv_path, args.out, args.vocab_size,
                                         args.max_len, args.seed,
                                         args.bpe_merges)
    elif args.synthetic and args.dataset == "midi":
        with tempfile.TemporaryDirectory() as tmp:
            generate_midi_corpus(tmp, args.artists, args.songs, args.seed,
                                 (args.notes_lo, args.notes_hi))
            corpus = build_midi_corpus(tmp, args.out, args.max_len,
                                       args.seed, args.bpe_merges)
    else:
        sys.exit("need --synthetic, --lyrics_csv, or --midi_root")
    print(f"packed {corpus.songs.shape[0]} songs / "
          f"{corpus.num_artists} artists -> {args.out} "
          f"(vocab={len(corpus.vocab)}, max_len={corpus.max_len}, "
          f"splits={ {k: len(v) for k, v in corpus.splits.items()} })",
          flush=True)


COMMANDS = {"prepare": prepare_main, "train": train_main,
            "evaluate": evaluate_main, "sample": sample_main,
            "make-eval-set": make_eval_set_main}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        sys.exit(f"usage: python -m fewshot_torch.cli "
                 f"{{{','.join(COMMANDS)}}} [flags]")
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
