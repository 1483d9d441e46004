"""The PyTorch port's distributed stack over several processes: gloo ranks
on the CPU, spawned, one intra-op thread each, meeting through a
``FileStore`` under the test's tmp dir (the launcher test through the TCP
coordinator it is given), each collective bounded by a 120 s timeout.

- A ``make_lm_train_step`` step on a (2, 2) ("data", "model") mesh, its
  parameters and AdamW moments placed by ``train_shardings`` and its
  batch by ``shard_batch``, against the single-device step: loss within
  1e-5 relative and parameters within 1e-4 (the JAX package's own mesh
  test allows 2e-3).
- Compressed gradients on a (2, 2) ("pod", "data") mesh against JAX's
  arithmetic on the full batch, with the JAX test's bounds.
- A checkpoint saved on 4 ranks restored onto 2 ranks and onto 1.
- A rank whose data fails mid-run on a (2, 1) mesh: both ranks leave the
  loop with an error well inside the group's timeout, and the newest
  checkpoint restores to the parameters of the last step both finished.
- ``launch.train.main`` in two processes (the MoE smoke model) against
  one process's step on the batch assembled from each rank's rows; the
  same for the Mamba2 smoke model, whose replicated parameters (``A_log``
  among them) must also stay equal on both ranks.
- The gradients of the Mamba2, Hymba and MLA smoke models on a (2, 2)
  ("data", "model") mesh against one process's, on every rank: an op run
  block by block (``dist.blockwise``) whose argument lacks a split dim
  hands back a partial sum of its gradient.
- The embedding lookup from tables split over the vocab or with the batch
  split over both mesh dims against the plain lookup.
- ``maybe_initialize_distributed`` refusing ranks whose PYTHONHASHSEEDs
  differ (two processes started with their own seeds).

The ranks import neither JAX nor the JAX package; the JAX reference runs
in the test's own process.
"""
import dataclasses
import datetime
import os
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import build_model, get_arch  # noqa: E402
from repro_torch.launch.dryrun import _GradRecorder  # noqa: E402
from repro_torch.nn.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import AdamW, make_lm_train_step  # noqa: E402

SPAWN_TIMEOUT_S = 300
# every spawned rank hashes strings alike: DTensor's ties between equally
# cheap placements follow the hashing (launch.distributed checks it)
HASH_SEED = "0"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(fn, world, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes; a
    rank's exception is raised here with its traceback. Every rank starts
    with ``PYTHONHASHSEED=HASH_SEED``."""
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = HASH_SEED
    try:
        ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False, start_method="spawn")
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = seed
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} still running after {SPAWN_TIMEOUT_S} s")


def _join(rank, world, store, timeout_s=120):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _lm_cfg():
    return dataclasses.replace(get_arch("gemma2_2b").smoke, n_layers=2, vocab=256, act_dtype=torch.float32,
                               remat=True)


def _lm_batch(cfg, B=4, S=16):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


# ------------------------------------------------------------------ the ranks


def _sharded_step_rank(rank, world, store, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.data import shard_batch
    from repro_torch.dist import device_put, on_mesh, train_shardings

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = _lm_cfg()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        opt = AdamW(lr=1e-3, weight_decay=0.01)
        state = opt.init(params)
        host = _lm_batch(cfg)
        sh = train_shardings(mesh, model.axes(), model.abstract(), state, host["tokens"].shape[0])
        p, s = device_put(params, sh.params), device_put(state, sh.opt_state)
        batch = shard_batch(host, sh.batch)  # every rank drew the same batch: its rows are distribute_tensor's
        for k, v in batch.items():
            want = distribute_tensor(torch.from_numpy(host[k]), mesh, sh.batch.placements).to_local()
            assert torch.equal(v.to_local(), want), k
        p, s, m = on_mesh(make_lm_train_step(model, opt, donate=True))(p, s, batch)
        full = [t.full_tensor() for t in tree_leaves(p)]
        moments = [t.full_tensor() for t in tree_leaves(s["m"])]
        specs = [tuple(x.spec) for x in tree_leaves(sh.params)]
        local = [tuple(t.to_local().shape) for t in tree_leaves(p)]
        if rank == 0:
            torch.save({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "params": full,
                        "m": moments, "specs": specs, "local": local}, out)
    finally:
        dist.destroy_process_group()


def _compressed_rank(rank, world, store, inputs, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import PartitionSpec as P
    from repro_torch.dist import make_compressed_dp_grad_fn, zeros_like_error

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
        data = np.load(inputs)
        params = {"w": torch.from_numpy(data["w"])}
        batch = {"x": torch.from_numpy(data["x"]), "y": torch.from_numpy(data["y"])}
        gf = make_compressed_dp_grad_fn(lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), mesh,
                                        P(("pod", "data")))
        g1, err1 = gf(params, batch, zeros_like_error(params, 2))
        g2, err2 = gf(params, batch, err1)
        if rank == 0:
            np.savez(out, g1=g1["w"].numpy(), err1=err1["w"].numpy(), g2=g2["w"].numpy(), err2=err2["w"].numpy())
    finally:
        dist.destroy_process_group()


def _tree(sizes=(8, 8)):
    w = torch.arange(float(np.prod(sizes))).reshape(sizes)
    return {"w": w, "b": torch.ones(sizes[1]), "n": [torch.arange(4, dtype=torch.int32)]}


def _elastic_rank(rank, world, store, ckpt_dir, mode):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import NamedSharding, PartitionSpec as P, device_put
    from repro_torch.train import AsyncCheckpointer, restore_checkpoint

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        sh = {"w": NamedSharding(mesh, P("data")), "b": NamedSharding(mesh, P()), "n": [NamedSharding(mesh, P())]}
        if mode == "save":
            ck = AsyncCheckpointer(ckpt_dir, process_index=rank, n_processes=world)
            ck.save(7, device_put(_tree(), sh))
            ck.close()
        else:
            got, step, _ = restore_checkpoint(ckpt_dir, _tree(), shardings=sh)
            assert step == 7 and got["w"].placements == sh["w"].placements
            assert tuple(got["w"].to_local().shape) == (8 // world, 8)
            for a, b in zip(tree_leaves(got), tree_leaves(_tree())):
                assert torch.equal(a.full_tensor(), b)
        dist.barrier()
    finally:
        dist.destroy_process_group()


RESCUE_TIMEOUT_S = 60


def _rescue_rank(rank, world, store, ckpt_dir, out):
    import itertools

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import FailingIterator, shard_batch
    from repro_torch.dist import device_put, on_mesh, train_shardings
    from repro_torch.train import LoopConfig, run_train_loop

    _join(rank, world, store, RESCUE_TIMEOUT_S)
    try:
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        cfg = _lm_cfg()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        opt = AdamW(lr=1e-3, weight_decay=0.01)
        state = opt.init(params)
        host = _lm_batch(cfg)
        sh = train_shardings(mesh, model.axes(), model.abstract(), state, host["tokens"].shape[0])
        step = on_mesh(make_lm_train_step(model, opt, donate=True))
        finished = []

        def recorded(p, s, b):
            p, s, m = step(p, s, b)
            finished.append([t.full_tensor() for t in tree_leaves(p)])  # both ranks, in step
            return p, s, m

        data = (shard_batch(host, sh.batch) for _ in itertools.count())
        if rank == 1:
            data = FailingIterator(data, fail_at=2)
        t0, err = time.monotonic(), None
        try:
            run_train_loop(recorded, device_put(params, sh.params), device_put(state, sh.opt_state), data,
                           LoopConfig(5, ckpt_dir, ckpt_every=1), log_fn=lambda _: None,
                           shardings={"params": sh.params, "opt_state": sh.opt_state})
        except Exception as e:  # noqa: BLE001 - what each rank raised is the result
            err = repr(e)
        torch.save({"err": err, "seconds": time.monotonic() - t0, "finished": finished}, out.format(rank))
    finally:
        dist.destroy_process_group()


def _launcher_rank(rank, world, port, out, arch="deepseek_moe_16b", n_micro=2):
    from repro_torch.launch import train as launch_train

    torch.set_num_threads(1)
    res = launch_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "4", "--seq", "16",
                             "--n-micro", str(n_micro), "--device", "cpu",
                             "--log-every", "1", "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                             str(world), "--process-id", str(rank)])
    assert not dist.is_initialized()
    torch.save({"losses": [h["loss"] for h in res.history], "aux": [h["aux"] for h in res.history], "step": res.step,
                "grad_norms": [h["grad_norm"] for h in res.history],
                "local": [tuple(t.to_local().shape) for t in tree_leaves(res.params)],
                "blocks": [t.to_local() for t in tree_leaves(res.params)],
                "split": [next((p.dim for p in t.placements if p.is_shard()), None) for t in tree_leaves(res.params)]},
               out.format(rank))


def _grads_rank(rank, world, store, arch, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import shard_batch
    from repro_torch.dist import device_put, on_mesh, train_shardings

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_arch(arch).smoke, act_dtype=torch.float32)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        host = _lm_batch(cfg)
        sh = train_shardings(mesh, model.axes(), model.abstract(), AdamW(lr=1e-3).init(params), host["tokens"].shape[0])
        rec = _GradRecorder()
        _, _, m = on_mesh(make_lm_train_step(model, rec))(device_put(params, sh.params), {}, shard_batch(host, sh.batch))
        torch.save({"loss": float(m["loss"]), "grads": [g.full_tensor() for g in tree_leaves(rec.grads)]},
                   out.format(rank))
    finally:
        dist.destroy_process_group()


def _lookup_rank(rank, world, store, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import mesh_ops
    from repro_torch.nn.embed import Embedding

    _join(rank, world, store)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        table, tokens = torch.randn(64, 8, generator=g), torch.randint(0, 64, (4, 16), generator=g)
        grad = torch.randn(4, 16, 8, generator=g)
        got = {}
        for name, table_pl, token_pl in [("vocab over one dim", (Replicate(), Shard(0)), (Shard(0), Replicate())),
                                         ("vocab over two dims", (Shard(0), Shard(0)), (Replicate(), Replicate())),
                                         ("batch over two dims", (Replicate(), Replicate()), (Shard(0), Shard(0)))]:
            t = distribute_tensor(table, mesh, table_pl).requires_grad_()
            with mesh_ops():
                x = Embedding(64, 8)({"table": t}, distribute_tensor(tokens, mesh, token_pl))
                y = x + x.float().square()  # the rows used twice
                (y * distribute_tensor(grad, mesh, y.placements)).sum().backward()
                got[name] = (y.full_tensor(), t.grad.full_tensor())
        if rank == 0:
            torch.save(got, out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ the tests


def _single_device_step(cfg, host):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    p, s, m = make_lm_train_step(model, opt)(params, opt.init(params), tree_map(torch.from_numpy, host))
    return p, s, m


def test_sharded_lm_step_on_a_2x2_mesh_equals_one_device(tmp_path):
    out = tmp_path / "rank0.pt"
    _spawn(_sharded_step_rank, 4, str(tmp_path / "store"), str(out))
    got = torch.load(out)
    cfg = _lm_cfg()
    p, s, m = _single_device_step(cfg, _lm_batch(cfg))
    assert abs(got["loss"] - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
    assert abs(got["grad_norm"] - float(m["grad_norm"])) <= 1e-5 * float(m["grad_norm"])
    for a, b in zip(got["params"], tree_leaves(p)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for a, b in zip(got["m"], tree_leaves(s["m"])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-9)
    # the embedding table (vocab, embed) is split four ways over ("model", "data")
    emb = [i for i, sp in enumerate(got["specs"]) if sp[:1] == (("model", "data"),)]
    assert emb and all(got["local"][i][0] * 4 == got["params"][i].shape[0] for i in emb)


def test_compressed_gradients_on_a_pod_data_mesh(tmp_path):
    """Four ranks each take a quarter of the rows; the mean of their
    gradients, quantized, against ``jax.grad`` on the full batch (the JAX
    test's bounds: rel < 0.02, then < 0.04 after one error-feedback step),
    and the second step within one quantization step of JAX's compressed
    arithmetic fed the same carried residual."""
    import jax
    import jax.numpy as jnp

    from jax.sharding import PartitionSpec as JP

    from repro.dist import compress as jcompress

    rng = np.random.default_rng(0)
    w = np.ones((8, 4), np.float32)
    x, y = rng.standard_normal((16, 8)).astype(np.float32), rng.standard_normal((16, 4)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", w=w, x=x, y=y)
    _spawn(_compressed_rank, 4, str(tmp_path / "store"), str(tmp_path / "inputs.npz"), str(tmp_path / "out.npz"))
    got = np.load(tmp_path / "out.npz")

    def loss_fn(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    params, batch = {"w": jnp.asarray(w)}, {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    g_ref = np.asarray(jax.grad(loss_fn)(params, batch)["w"])
    assert np.abs(got["g1"] - g_ref).max() / np.abs(g_ref).max() < 0.02
    assert np.abs(got["g2"] - g_ref).max() / np.abs(g_ref).max() < 0.04
    jgf = jcompress.make_compressed_dp_grad_fn(loss_fn, None, JP(("pod", "data")))
    jg2, jerr2 = jgf(params, batch, {"w": jnp.asarray(got["err1"])})
    step = np.abs(g_ref + got["err1"].sum(0)).max() / 127
    assert np.abs(got["g2"] - np.asarray(jg2["w"])).max() <= step
    assert np.abs(got["err2"] - np.asarray(jerr2["w"])).max() <= step


def test_checkpoint_saved_on_4_ranks_restores_onto_2_and_1(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import NamedSharding, PartitionSpec as P
    from repro_torch.train import restore_checkpoint

    d = tmp_path / "ckpt"
    _spawn(_elastic_rank, 4, str(tmp_path / "store4"), str(d), "save")
    step_dir = d / f"step_{7:010d}"
    assert sorted(os.listdir(step_dir)) == [f"shard_{r:05d}.ckpt" for r in range(4)]
    assert (d / "MANIFEST").read_text().split() == ["7", "4"]
    _spawn(_elastic_rank, 2, str(tmp_path / "store2"), str(d), "restore")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store1"), 1), world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        sh = {"w": NamedSharding(mesh, P("data")), "b": NamedSharding(mesh, P()), "n": [NamedSharding(mesh, P())]}
        got, step, _ = restore_checkpoint(str(d), _tree(), shardings=sh)
        assert step == 7
        for a, b in zip(tree_leaves(got), tree_leaves(_tree())):
            assert torch.equal(a.full_tensor(), b) and a.dtype == b.dtype
    finally:
        dist.destroy_process_group()


def test_a_failing_rank_leaves_a_restorable_checkpoint(tmp_path):
    """Rank 1's data fails after two steps while rank 0 waits in step 3's
    collectives. Saving issues no collective, so rank 1 writes its rescue
    shard and leaves, and rank 0's collective then fails: both ranks raise
    well inside the group's timeout, and the newest checkpoint (step 2,
    each rank's blocks, MANIFEST naming 2 ranks) restores to the parameters
    both ranks held after step 2, bit for bit."""
    from repro_torch.train import restore_checkpoint

    d, out = tmp_path / "ckpt", str(tmp_path / "rank{}.pt")
    _spawn(_rescue_rank, 2, str(tmp_path / "store"), str(d), out)
    ranks = [torch.load(out.format(r)) for r in range(2)]
    assert "injected data failure" in ranks[1]["err"] and ranks[0]["err"] is not None
    assert all(r["seconds"] < RESCUE_TIMEOUT_S for r in ranks), [r["seconds"] for r in ranks]
    assert len(ranks[1]["finished"]) == 2 and len(ranks[0]["finished"]) == 2
    assert (d / "MANIFEST").read_text().split() == ["2", "2"]
    cfg = _lm_cfg()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    got, step, _ = restore_checkpoint(str(d), {"params": params, "opt_state": AdamW(lr=1e-3).init(params)})
    assert step == 2
    for a, b in zip(tree_leaves(got["params"]), ranks[0]["finished"][-1]):
        assert torch.equal(a, b)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_launcher_equals_one_process_on_the_assembled_batch(tmp_path):
    """``--coordinator/--num-processes/--process-id`` over TCP: two ranks
    on a (2, 1) mesh train the MoE smoke model (its sort-based dispatch
    over the tokens of both ranks) in two micro-batches, rank r drawing the stream seeded r and
    keeping rows r * B/2 .. (r + 1) * B/2 of it. Both steps' losses and
    load-balance terms equal (1e-5 relative) one process's steps on the
    batches assembled from those rows; each rank holds half of every
    parameter split over "data"."""
    from repro_torch.launch.train import reference_steps

    out = str(tmp_path / "rank{}.pt")
    _spawn(_launcher_rank, 2, _free_port(), out)
    ranks = [torch.load(out.format(r)) for r in range(2)]
    assert ranks[0]["losses"] == ranks[1]["losses"] and ranks[0]["step"] == 2
    history, params = reference_steps("deepseek_moe_16b", 2, 4, 16, n_micro=2, world=2)
    np.testing.assert_allclose(ranks[0]["losses"], [h["loss"] for h in history], rtol=1e-5, atol=0)
    np.testing.assert_allclose(ranks[0]["aux"], [h["aux"] for h in history], rtol=1e-5, atol=0)
    shapes = [tuple(t.shape) for t in tree_leaves(params)]
    assert any(loc != full for loc, full in zip(ranks[0]["local"], shapes))


def test_two_process_mamba2_launcher_keeps_the_replicas_equal(tmp_path):
    """The launcher test's two ranks on a (2, 1) mesh with the Mamba2 smoke
    model (its scan run block by block over the batch): both steps' losses
    and gradient norms equal (1e-5 relative) one process's on the
    assembled batches, and after two steps both ranks hold the same
    parameters, within 1e-6 of one process's. A gradient that stayed a
    rank's partial sum (``A_log``'s, whose scan argument has no batch dim)
    would update each replica apart."""
    from repro_torch.launch.train import reference_steps

    out = str(tmp_path / "rank{}.pt")
    _spawn(_launcher_rank, 2, _free_port(), out, "mamba2_2_7b", 1)
    ranks = [torch.load(out.format(r)) for r in range(2)]
    full = []
    for a, b, d in zip(ranks[0]["blocks"], ranks[1]["blocks"], ranks[0]["split"]):
        if d is None:  # a replica on each rank
            assert torch.equal(a, b)
        full.append(a if d is None else torch.cat([a, b], dim=d))
    history, params = reference_steps("mamba2_2_7b", 2, 4, 16, world=2)
    np.testing.assert_allclose(ranks[0]["losses"], [h["loss"] for h in history], rtol=1e-5, atol=0)
    np.testing.assert_allclose(ranks[0]["grad_norms"], [h["grad_norm"] for h in history], rtol=1e-5, atol=0)
    for a, b in zip(full, tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b", "deepseek_v2_lite_16b"])
def test_gradients_on_a_2x2_mesh_equal_one_process(arch, tmp_path):
    """One step's gradients of the smoke model (f32) on a (2, 2) ("data",
    "model") mesh, the batch over "data" and the heads over "model",
    gathered on each of the four ranks, against one process's: within 1e-5
    of each leaf's largest. Mamba2's and Hymba's scans and Hymba's
    attention run block by block over the batch and the heads, and so does
    MLA's attention, whose shared RoPE key has no heads dim. Whisper's and
    qwen2-vl's (its patch write) are held in ``test_torch_dist_data.py``."""
    out = str(tmp_path / "rank{}.pt")
    _spawn(_grads_rank, 4, str(tmp_path / "store"), arch, out)
    cfg = dataclasses.replace(get_arch(arch).smoke, act_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rec = _GradRecorder()
    _, _, m = make_lm_train_step(model, rec)(params, {}, tree_map(torch.from_numpy, _lm_batch(cfg)))
    want = tree_leaves(rec.grads)
    for r in range(4):
        got = torch.load(out.format(r))
        assert abs(got["loss"] - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
        for a, b in zip(got["grads"], want):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()) + 1e-12)


_JOIN_TWO = """
import sys
import torch.distributed as dist
from repro_torch.launch.distributed import maybe_initialize_distributed
try:
    maybe_initialize_distributed(sys.argv[1], 2, int(sys.argv[2]), device="cpu")
except RuntimeError as e:
    assert not dist.is_initialized()
    print("RAISED", e)
else:
    dist.barrier()
    dist.destroy_process_group()
    print("JOINED")
"""


@pytest.mark.parametrize("seeds,result", [(("1", "2"), "RAISED"), (("3", "3"), "JOINED")])
def test_ranks_with_different_hash_seeds_raise(seeds, result):
    """``maybe_initialize_distributed`` on two gloo ranks: where their
    PYTHONHASHSEEDs differ both raise, leave no process group, and say to
    export one seed for every rank; with one seed both join."""
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parent.parent / "src")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _JOIN_TWO, f"127.0.0.1:{port}", str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=src, PYTHONHASHSEED=seed, OMP_NUM_THREADS="1"))
             for rank, seed in enumerate(seeds)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.startswith(result), (out, err[-2000:])
        if result == "RAISED":
            assert "export one PYTHONHASHSEED" in out


def test_lookup_from_sharded_tables_equals_the_plain_lookup(tmp_path):
    """The embedding lookup on a (2, 2) mesh of gloo ranks: the vocab split
    over one mesh dim or over both with the tokens whole there (DTensor
    refused the second mask), and the tokens split over both dims, each
    with the rows used twice: the rows and the table's gradient equal the
    plain lookup's."""
    out = tmp_path / "rank0.pt"
    _spawn(_lookup_rank, 4, str(tmp_path / "store"), str(out))
    g = torch.Generator().manual_seed(0)
    table, tokens = torch.randn(64, 8, generator=g), torch.randint(0, 64, (4, 16), generator=g)
    grad = torch.randn(4, 16, 8, generator=g)
    t = table.clone().requires_grad_()
    x = t[tokens]
    y = x + x.square()
    (y * grad).sum().backward()
    got = torch.load(out)
    assert len(got) == 3
    for name, (rows, table_grad) in got.items():
        torch.testing.assert_close(rows, y.detach(), rtol=0, atol=0, msg=name)
        torch.testing.assert_close(table_grad, t.grad, rtol=1e-6, atol=1e-6, msg=name)
