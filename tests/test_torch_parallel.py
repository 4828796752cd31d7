"""Data parallelism over torch.distributed (gloo, CPU) against JAX's mesh.

One gloo world of 2 processes and one of 4 are spawned once for the file
(both at once, each worker importing torch and the port only), joined
through the ``FEWSHOT_*`` variables (``parallel/distributed.py``), and run
every case; the JAX side runs here, on the virtual CPU devices that
tests/conftest.py creates.  Checked for each world W:

* the fed train step (``make_fed_train_step(cfg, mesh=mesh)``) on the
  host pipeline's rows of rank r, 3 Adam steps from JAX's initial weights
  (cell=scan, fp32, dropout 0), for 3 pipeline seeds: the loss, the token
  count and the grad norm at every step within 1e-5 relative of JAX's
  ``make_fed_train_step(cfg, mesh=make_mesh(jax.devices()[:W]))`` fed the
  same episodes sharded over its W devices (only the order of fp32 sums
  differs: the all-reduce adds the ranks' partial sums, JAX's psum the
  devices'), and the parameters after the steps within 5e-5 of JAX's,
  relative to each leaf's largest magnitude: Adam divides each element's
  gradient by its own RMS, so an element whose gradient is far below its
  leaf's largest carries the 1e-7 summation noise into its update
  magnified.  The largest error of the 3 seeds and both worlds is
  1.454e-05 (lstm.0.b, seed 13, world 4; seeds 14 and 15 reach 5.1e-06
  and 2.5e-06; the test prints each under ``-s``), so the bound keeps
  3.4x headroom; it is the bound of tests/test_torch_training.py for
  parameters after Adam steps;
* the fed evaluation with the val pipe's rows split over the ranks and
  the (ce_sum, count) pair all-reduced equals the whole batch evaluated in
  one process, within 1e-6 relative;
* the ranks' parameters after the steps are the same bits;
* the device-sampler step (3 steps), the sharded evaluation and the
  sharded unigram floor, and a sample: the loss, the NLLs and the digest
  of the sampled tokens and of the parameters are the same on every rank
  (tests/test_distributed.py's checks of the JAX package);
* one all-reduce a train step;
* a checkpoint written by the world holds every rank's generator state,
  each rank restores its own, and a restore by a single process raises;
* a checkpoint holding a seed in place of the states (as
  ``orbax_to_torch.py`` writes it) seeds rank r with ``rank_seed(seed,
  r)``, so the ranks draw different episodes;
* a batch size that W does not divide raises;
* ``pipeline: host`` through the train CLI in the world, then resumed:
  only rank 0 prints and writes metrics.jsonl (each step once), the
  checkpoint holds W generator states, and the resumed run restores step
  4 and ends at 6.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from fewshot import training as jax_training
from fewshot.config import Config as JaxConfig
from fewshot.data.host_pipeline import HostEpisodePipeline as JaxPipeline
from fewshot.parallel.mesh import AXIS, make_mesh
from fewshot_torch import bridge, training
from fewshot_torch.config import Config
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.parallel.mesh import Mesh, rank_seed
from fewshot_torch.utils import ckpt

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
STEPS = 3
REL = 1e-5
PARAM_REL = 5e-5       # parameters after Adam steps (docstring)
CFG = dict(vocab_size=64, max_len=24, embed_dim=16, hidden_dim=24,
           num_layers=1, batch_size=8, support_size=2, query_size=2,
           lr=5e-3, cell="scan", compute_dtype="float32", dropout=0.0,
           grad_clip=1.0, data_parallel=True, eval_episodes=16,
           sample_tokens=8)
PIPE_SEEDS = (13, 14, 15)
CK_SEED = 21

WORKER = r"""
import hashlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from fewshot_torch import bridge, sampling, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.data.host_pipeline import HostEpisodePipeline
from fewshot_torch.models import unigram
from fewshot_torch.parallel import distributed, mesh as mesh_mod
from fewshot_torch.utils import ckpt

d = sys.argv[1]
assert distributed.maybe_initialize("cpu")
mesh = mesh_mod.make_mesh()
spec = json.load(open(d + "/spec.json"))
cfg = Config(**spec["cfg"])
corpus = PackedCorpus.load(d + "/corpus")
out = {"rank": mesh.rank, "world": mesh.world}
arrays = {}

def digest(params):
    h = hashlib.sha256()
    for k, p in params.named_parameters():
        h.update(k.encode() + p.detach().numpy().tobytes())
    return h.hexdigest()

# the fed step on this rank's rows of the host pipeline, for each seed
init = bridge.load_params(d + "/init.npz", "cpu")
step = training.make_fed_train_step(cfg, mesh=mesh)
out["fed"], out["fed_allreduce_calls"], out["fed_digest"] = {}, {}, {}
for seed in spec["pipe_seeds"]:
    params = bridge.load_params(d + "/init.npz", "cpu")
    state = training.TrainState(params, training.make_optimizer(cfg).init(
        params), 0, torch.Generator().manual_seed(0))
    pipe = HostEpisodePipeline(corpus, "train", cfg.batch_size,
                               cfg.support_size, cfg.query_size, seed=seed,
                               device="cpu", rank=mesh.rank, world=mesh.world)
    calls = mesh_mod.all_reduce_sum.calls
    fed = []
    for _ in range(spec["steps"]):
        state, m = step(state, next(pipe))
        fed.append([float(m[k]) for k in ("loss", "tokens", "grad_norm")])
    pipe.close()
    out["fed"][seed] = fed
    out["fed_allreduce_calls"][seed] = mesh_mod.all_reduce_sum.calls - calls
    out["fed_digest"][seed] = digest(state.params)
    for k, v in bridge.flatten(bridge.params_to_numpy(state.params)).items():
        arrays[f"fed{seed}:" + k] = v

# the fed evaluation on this rank's rows of the val pipe, summed over the
# world, and the whole batch in this process alone
def val_pipe(rank, world):
    return HostEpisodePipeline(corpus, "val", cfg.batch_size,
                               cfg.support_size, cfg.query_size, seed=7,
                               device="cpu", rank=rank, world=world)
calls = mesh_mod.all_reduce_sum.calls
for key, pipe, m in (("eval_fed", val_pipe(mesh.rank, mesh.world), mesh),
                     ("eval_fed_whole", val_pipe(0, 1), None)):
    out[key] = training.evaluate_fed(cfg, init, pipe, num_episodes=16,
                                     mesh=m)
    pipe.close()
out["eval_fed_allreduce_calls"] = mesh_mod.all_reduce_sum.calls - calls

# the device sampler: train, evaluate, floor, sample
data = eps.put_corpus(corpus, "cpu")
split = torch.as_tensor(corpus.splits["train"], dtype=torch.int64)
state = training.init_train_state(cfg, len(corpus.vocab), device="cpu",
                                  mesh=mesh)
step = training.make_train_step(cfg, data, split, mesh=mesh)
for _ in range(spec["steps"]):
    state, m = step(state)
out["loss"] = float(m["loss"])
out["digest"] = digest(state.params)
gen = lambda s: torch.Generator().manual_seed(mesh_mod.rank_seed(s, mesh))
out["eval"] = training.evaluate(cfg, state.params, data, split, gen(3),
                                num_episodes=16, mesh=mesh)
out["floor"] = unigram.evaluate_unigram(cfg, corpus, data, split, gen(4),
                                        num_episodes=16, mesh=mesh)
ep = eps.sample_episode(torch.Generator().manual_seed(5), data, split, 4,
                        k=cfg.support_size, q=cfg.query_size)
toks = sampling.generate(state.params, ep.support, ep.support_len,
                         [sampling.row_generator(6 + i, 1) for i in range(4)],
                         cfg)
out["sample"] = hashlib.md5(toks.numpy().tobytes()).hexdigest()

# the checkpoint: rank 0 writes every rank's generator; each restores its own
ckpt.save_checkpoint(d + f"/ck{mesh.world}", state, mesh=mesh)
arrays["gen"] = state.gen.get_state().numpy()
fresh = training.init_train_state(cfg, len(corpus.vocab), device="cpu",
                                  mesh=mesh, seed=99)
restored, ok = ckpt.recover_or_init(d + f"/ck{mesh.world}", fresh, mesh=mesh)
out["restored_gen_equal"] = bool(ok and torch.equal(
    restored.gen.get_state(), state.gen.get_state()))
out["restored_params_equal"] = digest(restored.params) == out["digest"]

# a converted JAX checkpoint (orbax_to_torch.py: a seed in place of the
# generator states) seeds each rank with its own seed of it
ck = d + f"/ckseed{mesh.world}"
if mesh.rank == 0:
    import shutil
    shutil.copytree(d + f"/ck{mesh.world}", ck)
    last = str(ckpt.latest_step(ck))
    np.savez(ck + "/" + last + "/rng.npz", seed=np.int64(spec["ck_seed"]))
mesh_mod.barrier(mesh)
restored, ok = ckpt.recover_or_init(ck, fresh, mesh=mesh)
assert ok
arrays["seeded_gen"] = restored.gen.get_state().numpy()

# a batch the world does not divide
import dataclasses
try:
    training.make_train_step(dataclasses.replace(
        cfg, batch_size=2 * mesh.world + 1), data, split, mesh=mesh)
    out["indivisible_raised"] = False
except ValueError as e:
    out["indivisible_raised"] = "not divisible" in str(e)

# the train CLI on the host pipeline in this world, then resumed
import contextlib, io
from fewshot_torch import cli
ck = d + f"/cli{mesh.world}"
args = ["train", "--device", "cpu", "--checkpt_dir", ck, "--set",
        f"corpus_dir={d}/corpus", "max_len=24", "vocab_size=64",
        "embed_dim=16", "hidden_dim=24", "num_layers=1", "batch_size=8",
        "support_size=2", "query_size=2", "pipeline=host", "cell=scan",
        "log_interval=2", "eval_interval=2", "eval_episodes=8",
        "checkpoint_interval=2"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    cli.main(args + ["max_steps=4"])
    cli.main(args + ["max_steps=6"])
out["cli_stdout"] = buf.getvalue()

np.savez(d + f"/w{mesh.world}_r{mesh.rank}.npz", **arrays)
json.dump(out, open(d + f"/w{mesh.world}_r{mesh.rank}.json", "w"))
print("DONE", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tiny_corpus, tmp_path_factory):
    """Write the inputs, run both worlds at once, and return
    {W: [rank 0's (json, arrays), ...]} with the JAX init params."""
    d = tmp_path_factory.mktemp("worlds")
    corpus = PackedCorpus(**{f: getattr(tiny_corpus, f) for f in
                             PackedCorpus.__dataclass_fields__})
    corpus.save(d / "corpus")
    jstate = jax_training.init_train_state(JaxConfig(**CFG), 64)
    init = jax.tree.map(np.asarray, jstate.params)
    np.savez(d / "init.npz", **bridge.flatten(init))
    (d / "spec.json").write_text(json.dumps(
        {"cfg": CFG, "steps": STEPS, "pipe_seeds": PIPE_SEEDS,
         "ck_seed": CK_SEED}))
    procs = []
    for w in WORLDS:
        port = _free_port()
        for r in range(w):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("JAX", "XLA"))}
            env.update(FEWSHOT_COORDINATOR=f"127.0.0.1:{port}",
                       FEWSHOT_NUM_PROCESSES=str(w),
                       FEWSHOT_PROCESS_ID=str(r), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(d)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    res = {w: [(json.loads((d / f"w{w}_r{r}.json").read_text()),
                dict(np.load(d / f"w{w}_r{r}.npz"))) for r in range(w)]
           for w in WORLDS}
    return {"dir": d, "init": init, "res": res, "corpus": tiny_corpus}


def _jax_fed(tiny_corpus, init, w, seed):
    """JAX's fed step over a mesh of w devices, on the same episodes."""
    cfg = JaxConfig(**CFG)
    mesh = make_mesh(jax.devices()[:w])
    opt = jax_training.make_optimizer(cfg)
    params = jax.tree.map(jax.numpy.asarray, init)
    state = jax_training.TrainState(params, opt.init(params),
                                    jax.numpy.int32(0),
                                    jax.random.PRNGKey(0))
    step = jax_training.make_fed_train_step(cfg, mesh=mesh)
    pipe = JaxPipeline(tiny_corpus, "train", CFG["batch_size"], 2, 2,
                       seed=seed, sharding=NamedSharding(mesh, P(AXIS)))
    metrics = []
    try:
        for _ in range(STEPS):
            state, m = step(state, next(pipe))
            metrics.append([float(m[k]) for k in ("loss", "tokens",
                                                  "grad_norm")])
    finally:
        pipe.close()
    return metrics, bridge.flatten(jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("w", WORLDS)
def test_fed_step_matches_jax_mesh(worlds, w):
    for seed in PIPE_SEEDS:
        want, want_params = _jax_fed(worlds["corpus"], worlds["init"], w,
                                     seed)
        for out, arrays in worlds["res"][w]:
            got = np.asarray(out["fed"][str(seed)])
            np.testing.assert_allclose(got, np.asarray(want), rtol=REL,
                                       atol=0)
            errs = {k: np.abs(arrays[f"fed{seed}:" + k] - v).max()
                    / np.abs(v).max() for k, v in want_params.items()}
            worst = max(errs, key=errs.get)
            print(f"world {w} seed {seed} rank {out['rank']}: largest "
                  f"parameter error {errs[worst]:.3e} on {worst}")
            assert errs[worst] <= PARAM_REL, (w, seed, worst, errs[worst])
            assert out["fed_allreduce_calls"][str(seed)] == STEPS


@pytest.mark.parametrize("w", WORLDS)
def test_fed_eval_split_over_ranks(worlds, w):
    """The val pipe's rows split over the ranks and summed: the whole
    batch's NLL, on every rank, with one all-reduce a call."""
    for out, _ in worlds["res"][w]:
        assert out["eval_fed_allreduce_calls"] == 1
        np.testing.assert_allclose(out["eval_fed"], out["eval_fed_whole"],
                                   rtol=1e-6, atol=0)
        assert out["eval_fed"] == worlds["res"][w][0][0]["eval_fed"]


@pytest.mark.parametrize("w", WORLDS)
def test_seeded_checkpoint_seeds_each_rank(worlds, w):
    """A checkpoint holding a seed (orbax_to_torch.py) restores rank r's
    generator as rank_seed(seed, r): the ranks' generators differ."""
    states = [arrays["seeded_gen"] for _, arrays in worlds["res"][w]]
    assert len({s.tobytes() for s in states}) == w
    for r, s in enumerate(states):
        want = torch.Generator().manual_seed(
            rank_seed(CK_SEED, Mesh(r, w))).get_state().numpy()
        assert np.array_equal(s, want), r


@pytest.mark.parametrize("w", WORLDS)
def test_ranks_bit_identical(worlds, w):
    res = worlds["res"][w]
    first, arrays0 = res[0]
    for r, (out, arrays) in enumerate(res):
        assert (out["rank"], out["world"]) == (r, w)
        assert out["fed_digest"] == first["fed_digest"]
        for k in arrays0:
            if k.startswith("fed"):
                assert np.array_equal(arrays[k], arrays0[k]), k
        for k in ("loss", "digest", "eval", "floor", "sample"):
            assert out[k] == first[k], (k, out[k], first[k])
    assert np.isfinite([first["loss"], first["eval"], first["floor"]]).all()
    # the ranks drew different episodes: their generators differ
    assert len({arrays["gen"].tobytes() for _, arrays in res}) == w


@pytest.mark.parametrize("w", WORLDS)
def test_checkpoint_generators_and_world_size(worlds, w):
    res = worlds["res"][w]
    for out, _ in res:
        assert out["restored_gen_equal"] and out["restored_params_equal"]
        assert out["indivisible_raised"]
    d = worlds["dir"] / f"ck{w}"
    step = ckpt.latest_step(d)
    with np.load(d / str(step) / "rng.npz") as z:
        gens = z["gens"]
    assert gens.shape[0] == w
    for r, (_, arrays) in enumerate(res):
        assert np.array_equal(gens[r], arrays["gen"])
    cfg = Config(**CFG)
    single = training.init_train_state(cfg, len(worlds["corpus"].vocab),
                                       device="cpu")
    with pytest.raises(ValueError, match=f"written by {w} process"):
        ckpt.recover_or_init(d, single)


@pytest.mark.parametrize("w", WORLDS)
def test_cli_host_pipeline_in_world(worlds, w):
    res = worlds["res"][w]
    assert "restored checkpoint at step 4" in res[0][0]["cli_stdout"]
    assert all(out["cli_stdout"] == "" for out, _ in res[1:])
    d = worlds["dir"] / f"cli{w}"
    recs = [json.loads(x) for x in
            (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [2, 4, 6]
    assert [r["step"] for r in recs if "val_nll" in r] == [2, 4, 6]
    assert ckpt.latest_step(d) == 6
    with np.load(d / "6" / "rng.npz") as z:
        assert z["gens"].shape[0] == w
