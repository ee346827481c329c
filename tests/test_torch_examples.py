"""The port's runnable examples (accl_tpu_torch/examples/) against the JAX
package's, on the CPU with `--device cpu`.

The reference's demos (examples/generate.py, examples/train_lm.py) are
scripts that pick their own devices, so their loops are written out here
over the JAX package's functions, with the demos' config and batch rules
(examples/generate.py:54-68, examples/train_lm.py:73-127), on the suite's
CPU devices. The same weights (drawn by the JAX package, carried across
with interop) go through both. Three JAX programs are compiled, each in a
module-scoped fixture: the decode step on dp2.sp1.tp2, the dense train
step on dp2.sp2.tp2 and the MoE train step on dp2.ep4.

Bounds: the decode logits within rtol = atol = 2e-4 (tests/test_torch_
mesh.py's), the greedy tokens equal; the train losses within the
reference test's rtol=2e-4, atol=2e-5. Resumed training is held bitwise
against straight training.
"""

import dataclasses
import io
import pathlib
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accl_tpu.models import moe as ref_moe
from accl_tpu.models import transformer as ref_trf
from accl_tpu.parallel import factorize_devices as ref_factorize
from accl_tpu.parallel import make_mesh as ref_make_mesh
from accl_tpu_torch.examples import generate as gen_ex
from accl_tpu_torch.examples import train_lm as train_ex
from accl_tpu_torch.interop import (moe_params_from_numpy,
                                    transformer_params_from_numpy)
from accl_tpu_torch.models import transformer as trf

REPO = pathlib.Path(__file__).resolve().parent.parent
PROMPT, NEW = 8, 8
STEPS = 2


def _ref_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ref_make_mesh(axes, devices=jax.devices()[:n])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run_main(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _losses(text: str) -> list[float]:
    return [float(line.split("loss")[1]) for line in text.splitlines()
            if line.startswith("step ")]


def _same(a, b) -> bool:
    la, lb = trf._tree_leaves(a), trf._tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decode_ref():
    """The reference demo's greedy loop (examples/generate.py:70-90) on
    its mesh at 4 devices: tokens and each step's logits, and its
    weights."""
    rcfg = ref_trf.TransformerConfig(**gen_ex.CONFIG)
    mesh = _ref_mesh({"dp": 2, "sp": 1, "tp": 2})
    params_np = _np(ref_trf.init_params(rcfg, jax.random.key(0)))
    params = ref_trf.shard_params(params_np, rcfg, mesh)
    B = 2
    prompt = gen_ex.make_prompt(rcfg.vocab, B, PROMPT, 0)
    total = PROMPT + NEW
    step = ref_trf.make_decode_step(rcfg, mesh)
    cache = ref_trf.init_kv_cache(rcfg, mesh, B, max_len=total)
    toks, logits = prompt, []
    for t in range(total - 1):
        lg, cache = step(params, cache, toks[:, t:t + 1],
                         jnp.array([t], jnp.int32))
        logits.append(np.asarray(lg[:, 0]))
        if t >= PROMPT - 1:
            nxt = np.asarray(jnp.argmax(lg[:, 0], -1), np.int32)[:, None]
            toks = np.concatenate([toks, nxt], axis=1)
    return {"np": params_np, "prompt": prompt, "tokens": toks,
            "logits": np.stack(logits, 1)}


def test_greedy_tokens_are_the_reference_decodes(decode_ref):
    cfg = trf.TransformerConfig(**gen_ex.CONFIG)
    mesh = gen_ex.example_mesh(4, "cpu")
    assert mesh.shape == {"dp": 2, "sp": 1, "tp": 2}
    params = trf.shard_params(
        transformer_params_from_numpy(decode_ref["np"], "cpu"), cfg, mesh)
    logits = []
    toks = gen_ex.generate_tokens(cfg, mesh, params, decode_ref["prompt"],
                                  NEW, logits=logits)
    np.testing.assert_allclose(torch.stack(logits, 1).numpy(),
                               decode_ref["logits"], rtol=2e-4, atol=2e-4)
    assert toks.tolist() == decode_ref["tokens"].tolist()


def test_sampling_is_reproducible_from_a_seed():
    cfg = trf.TransformerConfig(**gen_ex.CONFIG)
    mesh = gen_ex.example_mesh(2, "cpu")
    params = trf.shard_params(trf.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"), cfg, mesh)
    prompt = gen_ex.make_prompt(cfg.vocab, 2, 4, 5)

    def sample(seed):
        return gen_ex.generate_tokens(
            cfg, mesh, params, prompt, 6, temp=0.8,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(6), sample(6), sample(7)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[:, :4], torch.as_tensor(prompt).long())


@pytest.mark.parametrize("world,batch,want", [(4, 3, 4), (4, 2, 2),
                                              (3, 2, 3), (8, 1, 4)])
def test_batch_rounds_up_to_a_dp_multiple(world, batch, want):
    mesh = gen_ex.example_mesh(world, "cpu")
    assert gen_ex.round_batch(batch, mesh) == want


def test_generate_main_prints_the_reference_lines():
    out = _run_main(gen_ex.main, ["--device", "cpu", "--batch", "3",
                                  "--steps", "3", "--prompt-len", "4"])
    lines = out.splitlines()
    assert lines[0] == ("mesh={'dp': 2, 'sp': 1, 'tp': 2} prompt_len=4 "
                        "generated=3")
    assert [line.split(":")[0] for line in lines[1:]] == ["  seq[0]",
                                                          "  seq[1]"]


@pytest.mark.parametrize("main", [gen_ex.main, train_ex.main],
                         ids=["generate", "train_lm"])
def test_cuda_without_a_card_exits_nonzero(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--steps", "1"])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _ref_dense(world):
    """The reference demo's dense set-up (examples/train_lm.py:99-127):
    its config, mesh and batch."""
    axes = ref_factorize(world)
    heads = max(4, axes["tp"] * 2)
    kv = heads // 2 if (heads // 2) % axes["tp"] == 0 else heads
    cfg = ref_trf.TransformerConfig(vocab=128, d_model=heads * 8,
                                    n_heads=heads, n_kv_heads=kv,
                                    n_layers=2, d_ff=heads * 16)
    mesh = _ref_mesh(axes)
    tokens, targets = ref_trf.demo_batch(
        cfg, mesh, batch=max(2, axes["dp"]) * 2,
        seq=max(32, axes["sp"] * 16))
    return axes, cfg, mesh, tokens, targets


def _ref_moe(world, top_k):
    """The reference demo's MoE set-up (examples/train_lm.py:67-97)."""
    ep = 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)
    axes = {"dp": world // ep, "ep": ep}
    cfg = ref_moe.MoEConfig(d_model=64, d_ff=128, n_experts=ep,
                            experts_per_rank=1, vocab=128, seq=32,
                            top_k=top_k)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2 * world, cfg.seq)).astype(
        np.int32)
    return axes, cfg, _ref_mesh(axes), tokens, np.roll(tokens, -1, 1)


@pytest.fixture(scope="module")
def dense_ref():
    axes, cfg, mesh, tokens, targets = _ref_dense(8)
    params_np = _np(ref_trf.init_params(cfg, jax.random.key(0)))
    step = ref_trf.make_train_step(cfg, mesh, lr=3e-2)
    params = ref_trf.shard_params(params_np, cfg, mesh)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, tokens, targets)
        losses.append(float(loss))
    return {"axes": axes, "cfg": cfg, "np": params_np,
            "tokens": np.asarray(tokens), "losses": losses}


@pytest.fixture(scope="module")
def moe_ref():
    axes, cfg, mesh, tokens, targets = _ref_moe(8, top_k=2)
    params_np = _np(ref_moe.init_moe_params(cfg, jax.random.key(0)))
    step = ref_moe.make_moe_train_step(cfg, mesh, lr=3e-2)
    params = ref_moe.place_moe_params(params_np, cfg, mesh)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, tokens, targets)
        losses.append(float(loss))
    return {"axes": axes, "cfg": cfg, "np": params_np, "tokens": tokens,
            "losses": losses}


def test_dense_losses_are_the_reference_demos(dense_ref):
    run = train_ex.dense_run(8, device="cpu")
    assert run.axes == dense_ref["axes"]
    assert dataclasses.asdict(run.cfg) == dataclasses.asdict(
        dense_ref["cfg"])
    assert run.tokens.tolist() == dense_ref["tokens"].tolist()
    params = run.place(transformer_params_from_numpy(dense_ref["np"],
                                                     "cpu"))
    losses = []
    for s in range(STEPS):
        params, loss = train_ex.train(run, params, s, 1, log=None)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, dense_ref["losses"], rtol=2e-4,
                               atol=2e-5)


def test_moe_top2_losses_are_the_reference_demos(moe_ref):
    run = train_ex.moe_run(8, top_k=2, device="cpu")
    assert run.axes == moe_ref["axes"]
    assert dataclasses.asdict(run.cfg) == dataclasses.asdict(moe_ref["cfg"])
    assert run.tokens.tolist() == moe_ref["tokens"].tolist()
    params = run.place(moe_params_from_numpy(moe_ref["np"], "cpu"))
    losses = []
    for s in range(STEPS):
        params, loss = train_ex.train(run, params, s, 1, log=None)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, moe_ref["losses"], rtol=2e-4,
                               atol=2e-5)


def test_pp_and_remat_runs_take_a_step():
    """--pp 2 and --remat keep the demo's config and batch at world 8, so
    their first loss is the plain run's."""
    plain = _losses(_run_main(train_ex.main, ["--device", "cpu",
                                              "--steps", "1"]))
    pp = _run_main(train_ex.main, ["--device", "cpu", "--steps", "1",
                                   "--pp", "2"])
    remat = _run_main(train_ex.main, ["--device", "cpu", "--steps", "1",
                                      "--remat"])
    assert pp.startswith("mesh {'dp': 2, 'sp': 1, 'tp': 2, 'pp': 2}")
    assert remat.splitlines()[0].endswith(" remat")
    # the printed losses (4 decimals) agree to their last digit
    np.testing.assert_allclose(_losses(pp), plain, atol=1.5e-4)
    np.testing.assert_allclose(_losses(remat), plain, atol=1.5e-4)


@pytest.mark.parametrize("argv,message,source", [
    (["--model", "moe", "--pp", "2"],
     "--pp/--remat apply to --model dense only",
     '"--pp/--remat apply to --model dense only"'),
    (["--model", "moe", "--remat"],
     "--pp/--remat apply to --model dense only",
     '"--pp/--remat apply to --model dense only"'),
    (["--top-k", "2"], "--top-k applies to --model moe only",
     '"--top-k applies to --model moe only"'),
    (["--pp", "3"], "--pp 3 does not divide 8 devices",
     'f"--pp {pp} does not divide {n_dev} devices"'),
])
def test_flag_refusals_give_the_reference_messages(argv, message, source):
    with pytest.raises(SystemExit) as e:
        train_ex.main(argv + ["--device", "cpu"])
    assert e.value.code == message
    assert source in (REPO / "examples" / "train_lm.py").read_text()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["dense", "moe"])
def test_resumed_steps_are_straight_steps_bitwise(model, tmp_path):
    if model == "moe":
        run = train_ex.moe_run(8, top_k=2, device="cpu")
    else:
        run = train_ex.dense_run(8, device="cpu")
    placed = run.place(run.init_params(torch.Generator().manual_seed(3)))
    straight, _ = train_ex.train(run, placed, 0, 6, log=None)
    # every replica of a leaf holds the same bits: the saved global tree
    # places back into exactly the stacked one
    assert _same(run.place(run.global_params(straight)), straight)
    first, _ = train_ex.train(run, placed, 0, 3, log=None)
    saved = train_ex.save_checkpoint(run, first, tmp_path, 3)
    assert saved == tmp_path / "step_000003"
    latest = train_ex.latest_checkpoint(tmp_path)
    assert latest == saved
    second, _ = train_ex.train(run, run.place(train_ex.restore(latest)), 3,
                               3, log=None)
    assert _same(second, straight)


def test_unfinished_checkpoints_are_skipped(tmp_path):
    run = train_ex.dense_run(2, device="cpu")
    placed = run.place(run.init_params(torch.Generator().manual_seed(0)))
    done = train_ex.save_checkpoint(run, placed, tmp_path, 3)
    (tmp_path / "step_000009.tmp-abc").mkdir()  # an interrupted save
    (tmp_path / "step_000009.tmp-abc" / train_ex.CKPT_FILE).write_bytes(
        (done / train_ex.CKPT_FILE).read_bytes())
    (tmp_path / "step_000012").mkdir()  # no parameters in it
    (tmp_path / "step_x").mkdir()
    assert train_ex.latest_checkpoint(tmp_path) == done
    assert train_ex.latest_checkpoint(tmp_path / "absent") is None
    # a second save of a step replaces the first whole
    again = train_ex.save_checkpoint(run, placed, tmp_path, 3)
    assert again == done
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000003", "step_000009.tmp-abc", "step_000012", "step_x"]


def test_pp2_checkpoint_resumes_at_pp1(tmp_path):
    pp2 = train_ex.dense_run(8, pp=2, device="cpu")
    placed, _ = train_ex.train(
        pp2, pp2.place(pp2.init_params(torch.Generator().manual_seed(4))),
        0, 2, log=None)
    saved = train_ex.save_checkpoint(pp2, placed, tmp_path, 2)
    tree = train_ex.restore(saved)
    # the per-layer list form, as a pp 1 run's
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 2
    pp1 = train_ex.dense_run(8, device="cpu")
    assert dataclasses.asdict(pp1.cfg) == dataclasses.asdict(pp2.cfg)
    resumed = pp1.place(tree)
    assert _same(pp1.global_params(resumed), pp2.global_params(placed))
    _, loss = train_ex.train(pp1, resumed, 2, 1, log=None)
    assert np.isfinite(float(loss))


def test_train_lm_checkpoint_resume_as_a_user_runs_it(tmp_path):
    ck = tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "accl_tpu_torch.examples.train_lm",
           "--device", "cpu", "--steps", "3", "--ckpt", str(ck)]
    first = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=300, cwd=REPO)
    assert first.returncode == 0, first.stderr[-2000:]
    assert f"saved {ck / 'step_000003'}" in first.stdout
    second = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=300, cwd=REPO)
    assert second.returncode == 0, second.stderr[-2000:]
    assert f"resumed from {ck / 'step_000003'}" in second.stdout
    assert "step_000006" in second.stdout
