"""The port's data and tensor parallelism on the CPU, over real gloo ranks.

Ranks are processes spawned with ``torch.multiprocessing`` (spawn), each on
one torch thread, joined by ``parallel/launch.initialize_distributed`` from
``torchrun``'s environment variables. One 2-rank world and one 4-rank world
run every distributed job of this file (the ``two_ranks`` and
``four_ranks`` fixtures); the tests compare what the ranks returned with
single-process runs of the port and of the JAX package on the same weights
(``utils/convert.params_from_jax``) and batches. JAX is imported inside the
tests and fixtures that use it, so that the spawned ranks, which import this
module, load torch alone.

- ``parallel/launch`` degrades to one process without a group;
- ``data/nyu.epoch_order`` shards as JAX's does, and the shards of a step
  are the single-process batch's rows;
- ``parallel/tp.tp_plan`` shards the tensors JAX's ``tp_param_specs``
  shards, on the transposed dim, packed blocks split each on its own, and
  ``shard_state_dict``/``gather_state_dict`` round-trip bit for bit;
- a ``dp=2`` step with HDN on shards of unequal HDN coverage, ``tp=2``
  steps (plain, SwiGLU, LoRA + SSF) and a ``tp=2 x dp=2`` step give the
  single-process loss and gradients, and the ``tp=2`` gradient JAX's;
- 3-step ``Trainer`` trajectories under ``dp=2`` and ``tp=2`` follow the
  single-process one, and a resumed ``tp=2`` run the uninterrupted one bit
  for bit;
- the int8 teacher under ``tp=2`` (row-parallel layers at the global
  scales) against the unsharded int8 forward;
- ``cli.train --dp 2`` (also with validation and early stopping, decided
  alike on every rank), ``cli.infer`` and ``cli.pseudo_label`` on 2 ranks
  against single-process runs;
- the refusals: ``world != dp * tp``, heads that do not split over ``tp``,
  ``--dp 2`` without ``torchrun``.
"""
import contextlib
import dataclasses
import json
import os
import socket
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distill_any_depth_tpu_torch.configs import MODELS, LossConfig, OptimizerConfig, TrainConfig
from distill_any_depth_tpu_torch.models.factory import create_model
from distill_any_depth_tpu_torch.parallel import launch
from distill_any_depth_tpu_torch.parallel.mesh import make_mesh, shard_batch
from distill_any_depth_tpu_torch.parallel.tp import (
    Split,
    gather_state_dict,
    gather_tensors,
    shard_model,
    shard_state_dict,
    shard_tensor,
    tp_plan,
)
from distill_any_depth_tpu_torch.train.state import create_train_state
from distill_any_depth_tpu_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, STEPS = 56, 4, 3
# the limits of tests/test_torch_train.py's trajectory against JAX
LOSS_RTOL, GRAD_NORM_RTOL, PARAM_MEAN_DIST = 6e-5, 1e-4, 2e-8
JOIN_S = 240


# ---------------------------------------------------------------- configs
def _tiny(models, role: str, **enc):
    """A 3-block ViT-B-shaped student (128 wide, 2 heads) or teacher (256
    wide, 4 heads, the ViT-L head's flags); "odd" is a 3-head teacher."""
    cfg = models["depthanything-base"]
    dim, heads = {"student": (128, 2), "teacher": (256, 4), "odd": (192, 3)}[role]
    e = dataclasses.replace(cfg.encoder, embed_dim=dim, depth=3, num_heads=heads,
                            out_indices=(0, 1, 2, 2), **enc)
    extra = {} if role == "student" else dict(trailing_head_relu=False, interp_to_input=True)
    return dataclasses.replace(cfg, encoder=e, features=32, out_channels=(16, 32, 48, 64),
                               **extra)


def _model(cfg, state: dict | None = None, mesh=None, quant: str = "none"):
    """The port's model of ``cfg`` on the CPU in fp32, from ``state`` (a full
    reference-layout state dict) when given, else seeded; with ``mesh``,
    this rank's tensor-parallel shard of it (``state`` sharded by
    ``shard_state_dict``)."""
    model = create_model(cfg, device="cpu", seed=None if state is not None else 0,
                         fused_tail=False, quant=quant)
    plan = shard_model(model, mesh)
    if state is not None:
        if plan:
            state = shard_state_dict(state, mesh.model_index, mesh.tp)
        model.load_state_dict(state, strict=True)
    return model, plan


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, 3, SIZE, SIZE).astype(np.float32)


class _FlatTeacher(torch.nn.Module):
    """A teacher whose depth is constant on the images marked by a first
    pixel above 5: HDN's depth-range contexts cover no pixel of such an
    image, so shards of a batch differ in HDN coverage."""

    def __init__(self, teacher):
        super().__init__()
        self.teacher = teacher

    def forward(self, x):
        depth, feat = self.teacher(x)
        flat = (x[:, 0, 0, 0] > 5)[:, None, None]
        return torch.where(flat, torch.full_like(depth, 0.5), depth), feat


# ---------------------------------------------------------------- spawning
@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(job, rank: int, world: int, port: int, out: str, args) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        assert launch.initialize_distributed(device="cpu")
        result = job(rank, world, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        Path(out, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(job, world: int, out: Path, *args) -> list:
    """Run ``job(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result, or fails with the ranks' tracebacks."""
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(job, r, world, port, str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = "\n".join(f.read_text() for f in sorted(out.glob("rank*.err")))
    assert not hung and all(p.exitcode == 0 for p in procs), (
        f"ranks {[p.exitcode for p in procs]} (hung: {len(hung)}):\n{errors}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- steps
def _loss(**kw) -> LossConfig:
    # global normalization: the hybrid one divides by near-zero segment MADs
    # at random init (tests/test_torch_train.py makes the same choice)
    return LossConfig(**{"normalization": "global", "use_hdn": False, **kw})


OPT = OptimizerConfig(lr=1e-4, weight_decay=1e-5, warmup_steps=0, schedule="none",
                      total_steps=10, max_grad_norm=0.0)


def step_grads(weights: dict, mesh, loss: LossConfig, x: np.ndarray,
               flat_teacher: bool = False) -> dict:
    """One step of the port from ``weights`` on this data rank's rows of the
    global batch ``x`` (no clip): the loss components and grad_norm, and
    every gradient gathered whole, keyed by parameter name."""
    student, plan = _model(_tiny(MODELS, "student", **weights.get("enc", {})),
                           weights["student"], mesh)
    teacher, _ = _model(_tiny(MODELS, "teacher"), weights["teacher"], mesh)
    teacher = _FlatTeacher(teacher) if flat_teacher else teacher
    group = None if mesh is None else mesh.model_group
    state = create_train_state(student, OPT, plan=plan, model_group=group)
    step = make_train_step(student, [teacher.requires_grad_(False)], loss, views_shared=True,
                           data_group=None if mesh is None else mesh.data_group)
    d, dp = (0, 1) if mesh is None else (mesh.data_index, mesh.dp)
    xb = torch.from_numpy(shard_batch({"x": x}, d, dp)["x"])
    metrics = {k: float(v) for k, v in step(state, 0, xb, xb).items() if k != "teacher_idx"}
    names = [n for n, _ in student.named_parameters()]
    grads = gather_tensors([p.grad for _, p in student.named_parameters()],
                           [plan.get(n) for n in names], group)
    return {"metrics": metrics, "grads": dict(zip(names, grads))}


def _assert_grads_close(got: dict, want: dict, rtol: float) -> None:
    """Each gradient's L2 distance within ``rtol`` of its norm, and the
    global norms within ``rtol``."""
    g = np.sqrt(sum(float(v.double().square().sum()) for v in got.values()))
    w = np.sqrt(sum(float(v.double().square().sum()) for v in want.values()))
    np.testing.assert_allclose(g, w, rtol=rtol)
    for k in want:
        d = float((got[k].double() - want[k].double()).norm())
        assert d <= rtol * float(want[k].double().norm()) + 1e-9, (k, d)


def _trainer_cfg(out: Path, dp: int = 1, tp: int = 1, teacher: str = "teacher",
                 **kw) -> TrainConfig:
    MODELS.setdefault("tiny-parallel-teacher", _tiny(MODELS, "teacher"))
    MODELS.setdefault("tiny-parallel-odd", _tiny(MODELS, "odd"))
    return TrainConfig(student=_tiny(MODELS, "student"), teachers=(f"tiny-parallel-{teacher}",),
                       loss=_loss(normalization="none"),
                       optimizer=OptimizerConfig(lr=1e-4, weight_decay=1e-5, warmup_steps=1,
                                                 schedule="cosine", total_steps=10),
                       batch_size=BATCH, image_size=SIZE, num_epochs=1, seed=3,
                       log_interval=100, checkpoint_interval=0, visualize_interval=0,
                       teacher_dtype="float32", student_compute_dtype="float32",
                       teacher_chunk=0, output_dir=str(out), dp=dp, tp=tp, **kw)


def _batches(steps: int = STEPS) -> list[dict]:
    rng = np.random.RandomState(5)
    return [{"image": rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)} for _ in range(steps)]


def run_trainer(cfg: TrainConfig, steps: int, resume: str | None = None) -> list[dict]:
    """``steps`` steps of a ``Trainer`` of ``cfg`` over ``_batches`` (this
    data rank's rows), resumed from ``resume`` if given; the metrics of
    each step."""
    from distill_any_depth_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device="cpu")
    if resume:
        trainer.resume(resume)
    seen = []
    d = 0 if trainer.mesh is None else trainer.mesh.data_index
    batches = [shard_batch(b, d, cfg.dp) for b in _batches(4)]
    trainer.run(lambda epoch: iter(batches), max_steps=steps, steps_per_epoch=len(batches),
                on_step=lambda s, m: seen.append(
                    {k: float(v) for k, v in m.items() if k != "teacher_idx"}))
    return seen


# ---------------------------------------------------------------- rank jobs
def _two_rank_jobs(rank: int, world: int, tmp: str, weights: dict, x: np.ndarray) -> dict:
    tmp = Path(tmp)
    out = {"gathered": launch.all_gather_array(np.array([rank, 10 + rank], np.int64)),
           "seed": launch.shared_random_seed(100 + rank), "main": launch.is_main_process()}
    launch.synchronize()
    dp2, tp2 = make_mesh(2, 1), make_mesh(1, 2)

    # shard / gather round trips (plain and SwiGLU), from the full state
    # and through a sharded model's reference_state
    from distill_any_depth_tpu_torch.utils.checkpoint import reference_state

    for ffn in ("mlp", "swiglu"):
        full = create_model(_tiny(MODELS, "student", ffn=ffn), device="cpu",
                            fused_tail=False).state_dict()
        back = gather_state_dict(shard_state_dict(full, tp2.model_index, 2), tp2.model_group)
        model, _ = _model(_tiny(MODELS, "student", ffn=ffn), full, tp2)
        out[f"roundtrip_{ffn}"] = (full, back, reference_state(model, tp2.model_group))

    hdn = _loss(use_hdn=True, hdn_variant="dr")
    out["dp2_hdn"] = step_grads(weights, dp2, hdn, x, flat_teacher=True)
    out["tp2"] = step_grads(weights, tp2, _loss(), x)
    out["tp2_swiglu"] = step_grads(weights["swiglu"], tp2, _loss(), x)
    out["tp2_lora"] = step_grads(weights["lora"], tp2, _loss(), x)

    out["traj_dp2"] = run_trainer(_trainer_cfg(tmp / "traj_dp2", dp=2), STEPS)
    out["traj_tp2"] = run_trainer(_trainer_cfg(tmp / "traj_tp2", tp=2), STEPS)
    run_trainer(_trainer_cfg(tmp / "whole", tp=2), 4)
    run_trainer(_trainer_cfg(tmp / "first", tp=2), 2)
    run_trainer(_trainer_cfg(tmp / "resumed", tp=2), 4, resume=str(tmp / "first"))

    # the int8 teacher, row-parallel layers at the global scales
    for quant in ("int8", "int8_pallas"):
        teacher, _ = _model(_tiny(MODELS, "teacher"), weights["teacher"], tp2, quant)
        with torch.no_grad():
            out[f"int8_{quant}"] = teacher(torch.from_numpy(x))[0]

    # refusals
    for name, call in (("world", lambda: make_mesh(1, 1)),
                       ("heads", lambda: _model(_tiny(MODELS, "odd"), None, tp2))):
        try:
            call()
            out[f"refuse_{name}"] = None
        except ValueError as e:
            out[f"refuse_{name}"] = str(e)

    # the CLIs, each rank on its share
    from distill_any_depth_tpu_torch.cli import infer, pseudo_label
    from distill_any_depth_tpu_torch.cli import train as train_cli

    os.chdir(ROOT)
    out["cli_train"] = train_cli.main(_train_args(tmp / "cli_train", "--dp", "2"))
    out["cli_val"] = train_cli.main(_train_args(tmp / "cli_val", "--dp", "2", *VAL_ARGS))
    out["infer"] = infer.main(_infer_args(tmp / "infer"))
    out["pseudo_label"] = pseudo_label.main(_label_args(tmp / "label"))
    return out


def _four_rank_jobs(rank: int, world: int, tmp: str, weights: dict, x: np.ndarray) -> dict:
    out = {"tp2dp2": step_grads(weights, make_mesh(2, 2), _loss(), x)}
    try:
        make_mesh(2, 1)
        out["refuse_world"] = None
    except ValueError as e:
        out["refuse_world"] = str(e)
    return out


def _train_args(out: Path, *extra) -> list[str]:
    return ["--device", "cpu", "--dataset_dir", "data/smoke", "--output_dir", str(out),
            "--student_arch", "depthanything-small", "--teacher_models", "depthanything-small",
            "--batch_size", "2", "--num_iterations", "1", "--image_size", str(SIZE),
            "--use_hdn_loss", "--normalization", "global", "--teacher_dtype", "float32",
            "--log_interval", "1", *extra]


# validation every epoch (3 of the 6 smoke rows, one a data rank at bs2) and
# early stopping: decisions every rank must take alike, or the next
# collective waits forever. At lr 0 the second epoch does not improve, so
# the run stops there.
VAL_ARGS = ("--num_iterations", "0", "--num_epochs", "4", "--val_split", "0.5",
            "--early_stopping", "1", "--lr", "0")


def _infer_args(out: Path) -> list[str]:
    return ["--device", "cpu", "--arch_name", "depthanything-small", "--input",
            "data/smoke/imgs", "--output_dir", str(out), "--processing_res", str(SIZE),
            "--dtype", "float32", "--batch_size", "1", "--save_npy"]


def _label_args(out: Path) -> list[str]:
    return ["--device", "cpu", "--arch_name", "depthanything-small", "--input",
            "data/smoke/imgs", "--output_dir", str(out), "--processing_res", str(SIZE),
            "--dtype", "float32", "--batch_size", "1"]


# ---------------------------------------------------------------- fixtures
def _jax_weights(role: str, seed: int, **enc) -> tuple:
    """A JAX tiny model's params (numpy) and their port state dict."""
    import jax
    import jax.numpy as jnp

    from distill_any_depth_tpu.configs import MODELS as JAX_MODELS
    from distill_any_depth_tpu.models.factory import create_model as jax_create_model
    from distill_any_depth_tpu_torch.utils.convert import params_from_jax

    jmodel = jax_create_model(_tiny(JAX_MODELS, role, **enc), attn_impl="reference")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    return jmodel, params, params_from_jax(params, _tiny(MODELS, role, **enc))


def _lora_weights() -> dict:
    """A seeded LoRA + SSF student with every adapter perturbed (B = 0 at
    init would leave A's gradient zero), as a state dict of the module."""
    model = create_model(_tiny(MODELS, "student", lora_rank=4, use_ssf=True), device="cpu",
                         seed=0, fused_tail=False)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_" in name or "ssf" in name:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.state_dict()


@pytest.fixture(scope="module")
def weights():
    """JAX-initialized student and teacher (plain), and the port's SwiGLU and
    LoRA + SSF students; a 4-image batch whose image 0 the flat teacher
    marks."""
    jstudent, sp, student = _jax_weights("student", 0)
    jteacher, tparams, teacher = _jax_weights("teacher", 1)
    swiglu = create_model(_tiny(MODELS, "student", ffn="swiglu"), device="cpu", seed=2,
                          fused_tail=False).state_dict()
    w = {"student": student, "teacher": teacher,
         "swiglu": {"student": swiglu, "teacher": teacher, "enc": {"ffn": "swiglu"}},
         "lora": {"student": _lora_weights(), "teacher": teacher,
                  "enc": {"lora_rank": 4, "use_ssf": True}}}
    x = _images(BATCH, 0)
    x[0, 0, 0, 0] = 7.0  # the flat teacher's mark: image 0 of rank 0's rows
    return w, x, (jstudent, sp, jteacher, tparams)


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    w, x, _ = weights
    tmp = tmp_path_factory.mktemp("two_ranks")
    return tmp, _spawn(_two_rank_jobs, 2, tmp / "spawn", str(tmp), w, x)


@pytest.fixture(scope="module")
def four_ranks(weights, tmp_path_factory):
    w, x, _ = weights
    tmp = tmp_path_factory.mktemp("four_ranks")
    return _spawn(_four_rank_jobs, 4, tmp / "spawn", str(tmp), w, x)


# ---------------------------------------------------------------- tests
def test_launch_single_process_degradation():
    """The contract of tests/test_launch_and_io.py's launch test."""
    assert not dist.is_initialized() and not launch.initialize_distributed(device="cpu")
    assert launch.process_count() == 1 and launch.process_index() == 0
    assert launch.is_main_process()
    launch.synchronize()
    assert launch.all_gather_array(np.arange(4)).shape == (1, 4)
    assert launch.shared_random_seed(123) == 123
    assert make_mesh(1, 1).data_group is None


def test_launch_helpers_over_two_ranks(two_ranks):
    """The helpers over a real group: the gather stacks the ranks' arrays in
    rank order, the seed is rank 0's, rank 0 alone is the main process."""
    _, ranks = two_ranks
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gathered"], [[0, 10], [1, 11]])
        assert got["seed"] == 100 and got["main"] == (r == 0)


@pytest.mark.parametrize("seed,num_shards", [(0, 1), (0, 2), (7, 3), (42, 4)])
def test_epoch_order_matches_jax(seed, num_shards):
    from distill_any_depth_tpu.data.nyu import epoch_order as jax_epoch_order
    from distill_any_depth_tpu_torch.data.nyu import epoch_order

    for indices in (23, list(range(100, 137))):
        for shard in range(num_shards):
            kw = dict(seed=seed, shuffle=True, shard_index=shard, num_shards=num_shards)
            np.testing.assert_array_equal(epoch_order(indices, **kw),
                                          jax_epoch_order(indices, **kw))


@pytest.mark.parametrize("dp,local", [(2, 3), (4, 2)])
def test_epoch_shards_are_the_single_process_batches(dp, local):
    """At step s the data ranks' rows are, interleaved, rows [s*B, (s+1)*B)
    of the single-process order (B = dp * local), and every shard yields the
    single-process number of steps."""
    from distill_any_depth_tpu_torch.data.nyu import epoch_order

    n, b = 53, dp * local
    single = epoch_order(n, seed=9)
    shards = [epoch_order(n, seed=9, shard_index=d, num_shards=dp) for d in range(dp)]
    steps = {len(s) // local for s in shards}
    assert steps == {n // b}
    for s in range(n // b):
        rows = np.stack([sh[s * local:(s + 1) * local] for sh in shards], 1).reshape(-1)
        np.testing.assert_array_equal(rows, single[s * b:(s + 1) * b])


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_tp_plan_matches_jax_specs(ffn):
    """Every tensor that JAX's tp_param_specs shards, and no other, is in
    tp_plan, on the transposed dim: a kernel [in, out] sharded on out is a
    weight [out, in] split on dim 0, on in a split on dim 1, a bias on dim 0.
    The spec of each leaf rides through params_from_jax as its value."""
    from jax.sharding import PartitionSpec as P

    import jax

    from distill_any_depth_tpu.parallel.tp import tp_param_specs
    from distill_any_depth_tpu_torch.utils.convert import params_from_jax

    _, params, _ = _jax_weights("student", 0, ffn=ffn)
    codes = {P(): 0, P(None, "model"): 1, P("model", None): 2, P("model"): 3}
    specs = tp_param_specs(params)
    coded = jax.tree_util.tree_map(lambda leaf, spec: np.full(leaf.shape, codes[spec], np.float32),
                                   params, specs, is_leaf=lambda x: isinstance(x, np.ndarray))
    sd = params_from_jax(coded, _tiny(MODELS, "student", ffn=ffn))
    plan = tp_plan(sd)
    want = {1: 0, 2: 1, 3: 0}
    jax_sharded = {k: want[int(v.reshape(-1)[0])] for k, v in sd.items() if v.reshape(-1)[0]}
    assert {k: s.dim for k, s in plan.items()} == jax_sharded
    assert len(jax_sharded) == 3 * 6  # per block: qkv (2), proj, fc1/w12 (2), fc2/w3
    packed = {k: s.parts for k, s in plan.items() if s.parts > 1}
    assert set(packed.values()) == ({3} if ffn == "mlp" else {2, 3})


def test_packed_splits_take_heads_of_each_block():
    """A rank's qkv rows are its heads of each of q, k and v, and a w12
    shard its columns of each of SwiGLU's halves: not a contiguous slice."""
    t = torch.arange(3 * 4 * 2).reshape(3 * 4 * 2, 1)  # 3 blocks x 4 heads x 2 dims
    got = shard_tensor(t, Split(0, 3), 1, 2).reshape(-1).tolist()
    assert got == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]
    w12 = torch.arange(8).reshape(1, 8)
    assert shard_tensor(w12, Split(1, 2), 0, 2).tolist() == [[0, 1, 4, 5]]
    with pytest.raises(ValueError):
        shard_tensor(t, Split(0, 3), 0, 3)


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_shard_gather_round_trip(two_ranks, ffn):
    """shard_state_dict then gather_state_dict, and a sharded model's
    gathered reference state, equal the full state bit for bit."""
    _, ranks = two_ranks
    for r in ranks:
        full, back, ref = r[f"roundtrip_{ffn}"]
        assert back.keys() == full.keys() and ref.keys() == full.keys()
        for k in full:
            assert torch.equal(back[k], full[k]) and torch.equal(ref[k], full[k]), k


def test_dp2_hdn_matches_single_process(weights, two_ranks):
    """dp=2 with HDN on shards of unequal coverage (image 0 uncovered): the
    global loss and gradients. A per-rank HDN denominator fails it: the
    ranks' mean of per-rank ratios is another loss."""
    w, x, _ = weights
    _, ranks = two_ranks
    hdn = _loss(use_hdn=True, hdn_variant="dr")
    single = step_grads(w, None, hdn, x, flat_teacher=True)
    for r in ranks:
        got = r["dp2_hdn"]
        for k, v in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        _assert_grads_close(got["grads"], single["grads"], 2e-5)
    assert single["metrics"]["hdn"] > 1e-3
    # the shards' coverage differs: rank 0's first image has none
    from distill_any_depth_tpu_torch.losses.distill import _contexts

    student, _ = _model(_tiny(MODELS, "student"), w["student"])
    teacher = _FlatTeacher(_model(_tiny(MODELS, "teacher"), w["teacher"])[0])
    with torch.no_grad():
        depth = teacher(torch.from_numpy(x))[0]
    covered = (_contexts(hdn, depth, None).sum(0) > 0).reshape(BATCH, -1).sum(1)
    assert covered[0] == 0 and covered[1:].min() > 0


@pytest.mark.parametrize("case", ["tp2", "tp2_swiglu", "tp2_lora"])
def test_tp2_matches_single_process(weights, two_ranks, case):
    """tp=2 (plain, SwiGLU with its packed w12, LoRA + SSF with qkv's B
    rows and proj's A columns sharded): the loss, grad_norm and the
    gathered gradients of the single-process step on the same weights."""
    w, x, _ = weights
    _, ranks = two_ranks
    ww = {"tp2": w, "tp2_swiglu": w["swiglu"], "tp2_lora": w["lora"]}[case]
    single = step_grads(ww, None, _loss(), x)
    for r in ranks:
        got = r[case]
        for k, v in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        _assert_grads_close(got["grads"], single["grads"], 2e-5)


def test_tp2_gradient_matches_jax(weights, two_ranks):
    """The tp=2 run's first gradient against JAX's value_and_grad of the same
    weights and batch (the loss of JAX's step, global normalization)."""
    import jax
    import jax.numpy as jnp

    from distill_any_depth_tpu.configs import LossConfig as JLossConfig
    from distill_any_depth_tpu.losses.distill import combined_distillation_loss
    from distill_any_depth_tpu_torch.utils.convert import params_from_jax

    w, x, (jstudent, sp, jteacher, tparams) = weights
    cfg = JLossConfig(normalization="global", use_hdn=False)

    def loss_fn(p, xj):
        sd, sf = jstudent.apply({"params": p}, xj)
        td, tf = jteacher.apply({"params": tparams}, xj)
        total, _ = combined_distillation_loss(cfg, sd, sd, sf, jax.lax.stop_gradient(td),
                                              jax.lax.stop_gradient(tf))
        return total

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(sp, jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), _tiny(MODELS, "student"))
    _, ranks = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r["tp2"]["metrics"]["total"], float(total), rtol=LOSS_RTOL)
        _assert_grads_close(r["tp2"]["grads"], want, 2e-4)


def test_tp2_dp2_matches_single_process(weights, four_ranks):
    """tp=2 x dp=2 on 4 ranks (tests/test_parallel.py's TP + DP contract)."""
    w, x, _ = weights
    single = step_grads(w, None, _loss(), x)
    for r in four_ranks:
        got = r["tp2dp2"]
        for k, v in single["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        _assert_grads_close(got["grads"], single["grads"], 2e-5)


@pytest.mark.parametrize("mode", ["dp2", "tp2"])
def test_trainer_trajectory_matches_single_process(two_ranks, mode, tmp_path):
    """3 Trainer steps on a loss without order statistics: each step's loss
    components and grad_norm, and the saved student_final, against a
    single-process Trainer (tests/test_torch_train.py's limits)."""
    tmp, ranks = two_ranks
    single = run_trainer(_trainer_cfg(tmp_path), STEPS)
    for r in ranks:
        for got, want in zip(r[f"traj_{mode}"], single, strict=True):
            for k, v in want.items():
                rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
                np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-8, err_msg=k)
    from distill_any_depth_tpu_torch.utils.checkpoint import read_safetensors

    got = read_safetensors(str(tmp / f"traj_{mode}" / "student_final.safetensors"))
    want = read_safetensors(str(tmp_path / "student_final.safetensors"))
    assert got.keys() == want.keys()
    dist_ = np.mean(np.concatenate([(got[k] - want[k]).abs().reshape(-1).numpy() for k in want]))
    assert dist_ < PARAM_MEAN_DIST
    assert json.loads((tmp / f"traj_{mode}" / "history.json").read_text())["lr"]


def test_tp2_resume_is_exact(two_ranks):
    """A tp=2 run resumed after step 2 of 4 ends bit for bit where the
    uninterrupted tp=2 run does, in the weights and the train state."""
    from distill_any_depth_tpu_torch.utils.checkpoint import read_safetensors, restore_train_state

    tmp, _ = two_ranks
    whole = read_safetensors(str(tmp / "whole" / "student_final.safetensors"))
    resumed = read_safetensors(str(tmp / "resumed" / "student_final.safetensors"))
    assert all(torch.equal(whole[k], resumed[k]) for k in whole)
    a, b = restore_train_state(str(tmp / "whole")), restore_train_state(str(tmp / "resumed"))
    assert int(a["step"]) == int(b["step"]) == 4
    assert all(torch.equal(p, q) for p, q in zip(a["params"], b["params"]))
    for x, y in zip(a["adam"], b["adam"]):
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_int8_teacher_tp2_matches_unsharded(weights, two_ranks, quant):
    """The int8 teacher under tp=2 (row-parallel layers quantized at the
    global row and column scales, partial products summed in fp32) against
    the unsharded int8 forward: the same integer products, summed in
    another order."""
    w, x, _ = weights
    _, ranks = two_ranks
    teacher, _ = _model(_tiny(MODELS, "teacher"), w["teacher"], quant=quant)
    with torch.no_grad():
        want = teacher(torch.from_numpy(x))[0]
    for r in ranks:
        got = r[f"int8_{quant}"]
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-5, err
        assert np.corrcoef(got.reshape(-1), want.reshape(-1))[0, 1] >= 0.99


def test_refusals(two_ranks, four_ranks, tmp_path):
    """world != dp * tp, heads that do not split, --dp 2 without torchrun."""
    from distill_any_depth_tpu_torch.cli import train as train_cli

    _, ranks = two_ranks
    for r in ranks:
        assert "dp * tp = 1 * 1 = 1" in r["refuse_world"] and "2 processes" in r["refuse_world"]
        assert "3 heads" in r["refuse_heads"] and "tp=2" in r["refuse_heads"]
    for r in four_ranks:
        assert "dp * tp = 2 * 1 = 2" in r["refuse_world"]
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        train_cli.main(["--output_dir", str(tmp_path), "--dp", "2"])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4"):
        train_cli.main(["--output_dir", str(tmp_path), "--dp", "2", "--tp", "2"])


def test_cli_train_dp2_writes_single_process_files(two_ranks, tmp_path, monkeypatch):
    """cli.train --dp 2 on 2 ranks writes the files of a single-process run
    (rank 0 alone, gathered): the same names, the same keys and shapes, the
    same learning rate and the same loss of its one step (a second step's
    loss follows Adam's first update, which moves an element whose
    gradient is near zero by about +-lr whatever its sign: the trajectory
    tests hold several steps on smaller models). The CLI's student computes
    in bf16, whose GEMMs round a batch of 1 and one of 2 apart: the loss read
    6.3e-4 relative apart with global normalization, and the limit is 3e-3."""
    from distill_any_depth_tpu_torch.cli import train as train_cli
    from distill_any_depth_tpu_torch.utils.checkpoint import read_safetensors

    tmp, ranks = two_ranks
    monkeypatch.chdir(ROOT)
    with _one_thread():
        single = train_cli.main(_train_args(tmp_path / "single"))

    def files(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())

    assert files(tmp / "cli_train") == files(tmp_path / "single")
    got = read_safetensors(str(tmp / "cli_train" / "student_final.safetensors"))
    want = read_safetensors(str(tmp_path / "single" / "student_final.safetensors"))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for r in ranks:
        assert r["cli_train"]["lr"] == single["lr"]
        np.testing.assert_allclose(r["cli_train"]["train_loss"], single["train_loss"],
                                   rtol=3e-3)


def test_cli_train_dp2_validates_and_stops_as_one_process(two_ranks, tmp_path, monkeypatch):
    """cli.train --dp 2 with validation every epoch and early stopping: the
    ranks' validation losses (reduced over the data ranks) equal one
    process's, every rank stops after the same epoch, and rank 0 wrote
    student_best."""
    from distill_any_depth_tpu_torch.cli import train as train_cli

    tmp, ranks = two_ranks
    monkeypatch.chdir(ROOT)
    with _one_thread():
        single = train_cli.main(_train_args(tmp_path / "single", *VAL_ARGS))
    assert len(single["val_loss"]) == 2  # validated, and stopped early
    for r in ranks:
        assert len(r["cli_val"]["val_loss"]) == len(single["val_loss"])
        np.testing.assert_allclose(r["cli_val"]["val_loss"], single["val_loss"], rtol=3e-3)
    assert (tmp / "cli_val" / "student_best.safetensors").exists()


@pytest.mark.parametrize("cli", ["infer", "pseudo_label"])
def test_cli_rank_shards_union_is_single_process(two_ranks, tmp_path, monkeypatch, cli):
    """Each rank writes its share of the sorted inputs, once each, and the
    union of the ranks' files equals a single-process run's, byte for
    byte."""
    from distill_any_depth_tpu_torch.cli import infer, pseudo_label

    tmp, ranks = two_ranks
    monkeypatch.chdir(ROOT)
    with _one_thread():  # as the ranks run, so that their GEMMs round alike
        if cli == "infer":
            single = infer.main(_infer_args(tmp_path))
            ranked = tmp / "infer"
        else:
            single = pseudo_label.main(_label_args(tmp_path))
            ranked = tmp / "label"
    shares = [r[cli] for r in ranks]
    assert all(shares) and not set(shares[0]) & set(shares[1])
    names = sorted(Path(p).name for s in shares for p in s)
    assert names == sorted(Path(p).name for p in single)
    for p in single:
        rel = Path(p).relative_to(tmp_path)
        assert (ranked / rel).read_bytes() == Path(p).read_bytes(), rel
