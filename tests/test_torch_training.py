"""The port's training path against the JAX package's on the CPU.

One module-scoped fixture runs the reference once (its CPU XLA path, as
``tests/test_training.py`` runs it) on the widths of that file (hidden
32, 2 layers, 4 heads over 2 kv heads of 8, vocab 89, sym_int4): the
causal-LM loss with and without a loss mask, the adapter gradients, five
QLoRA Adam steps and one full-parameter SGD step; the port runs the same
inputs (its CPU path: every kernel wrapper's plain version) and is held
to it.  The rest are the port's own behaviours: LISA's mask, ReLoRA's
merge-and-reset, identity at init, the checkpoint's bitwise resume, the
Trainer bridge, ``llm_patch`` and the serving paths, which build no
autograd graph.

Tolerances.  Both sides round activations to bf16 at the same points and
sum in different orders and widths (the port's plain versions in
float64), so single activations differ by one bf16 ulp (2^-8 relative);
through two layers a loss agrees to about 1e-3 (bound 5e-3 relative), a
gradient leaf to within 2.2% of its norm (bound 3e-2; 0.2-1.6% of its
elements, those nearest zero, differ in sign).  Adam moves every element
by about the learning rate whatever the size of its gradient, so those
sign differences become whole steps of opposite sign, and they compound
over five steps while the loss falls from 5.1 to 1.5: each step's loss
stays within LOSS_TOL, but the adapters end up to 23% of the distance
they moved apart (measured; bound 35%), pointing the same way (cosine of
the two moves at least 0.97 measured; bound 0.95).  A wrong gradient of a
whole slot would move it elsewhere (a cosine near 0, an error near 100%).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipex_llm_tpu import training as ref_training
from ipex_llm_tpu.ops.rope import RopeScaling
from ipex_llm_tpu.quantize import core as ref_qcore
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import (adapters_from_reference,
                                               params_from_reference)
from ipex_llm_tpu_torch.ops import attention as port_attention
from ipex_llm_tpu_torch.ops import linear as port_linear
from ipex_llm_tpu_torch.quantize import core as port_qcore
from ipex_llm_tpu_torch.training import (LoraConfig, PeftModel,
                                         ReLoRATrainer, TrainCheckpointer,
                                         attach_lora, causal_lm_loss,
                                         get_peft_model, init_lora,
                                         init_optimizer,
                                         jagged_cosine_schedule,
                                         make_lisa_train_step,
                                         make_qlora_train_step,
                                         make_train_step, merge_lora)
from ipex_llm_tpu_torch.training.lisa import sample_active_layers
from tests.test_decoder import rand_params, tiny_cfg
from tests.test_torch_quantize import reference_tree

LOSS_TOL = 5e-3
GRAD_TOL = 3e-2
STEP_TOL = 3e-2          # one SGD step
ADAM_TOL = 0.35          # five Adam steps, of the distance moved
ADAM_COS = 0.95
LR = 1e-2
N_STEPS = 5


def _tokens(vocab, b=2, t=12, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def pair():
    """The reference's run and the port's inputs, once for the module."""
    cfg = tiny_cfg(vocab_size=89, hidden_size=32, intermediate_size=64,
                   num_heads=4, num_kv_heads=2, head_dim=8)
    params = rand_params(cfg, qtype="sym_int4")
    lc = ref_training.LoraConfig(r=4, lora_alpha=8)
    adapters = ref_training.init_lora(jax.random.PRNGKey(0), cfg, params, lc)
    tokens = _tokens(cfg.vocab_size)
    mask = (np.random.default_rng(1).random((2, 11)) < 0.6).astype(
        np.float32)
    # B nonzero, so that the gradient reaches A too
    rng = np.random.default_rng(2)
    live = {s: {"a": ab["a"], "b": jnp.asarray(
        0.05 * rng.standard_normal(ab["b"].shape), jnp.float32)}
        for s, ab in adapters.items()}

    def lora_loss(ad):
        return ref_training.causal_lm_loss(
            cfg, ref_training.attach_lora(params, ad, lc), jnp.asarray(tokens))

    out = dict(cfg=cfg, params=params, lc=lc, tokens=tokens, mask=mask,
               adapters=_np_tree(adapters), live=_np_tree(live))
    out["loss"] = float(ref_training.causal_lm_loss(cfg, params,
                                                    jnp.asarray(tokens)))
    out["loss_masked"] = float(ref_training.causal_lm_loss(
        cfg, params, jnp.asarray(tokens), loss_mask=jnp.asarray(mask)))
    out["lora_loss"], grads = jax.value_and_grad(lora_loss)(live)
    out["lora_loss"] = float(out["lora_loss"])
    out["grads"] = _np_tree(grads)
    step = ref_training.make_qlora_train_step(cfg, optax.adam(LR), lc)
    ad, opt_state = adapters, optax.adam(LR).init(adapters)
    losses = []
    for _ in range(N_STEPS):
        ad, opt_state, loss = step(ad, opt_state, jnp.asarray(tokens),
                                   params)
        losses.append(float(loss))
    out["adam_losses"], out["adam_adapters"] = losses, _np_tree(ad)
    # one full-parameter SGD step on a bf16 model
    bf_params = rand_params(cfg, qtype="bf16")
    out["bf16_params"] = reference_tree(bf_params)
    out["full_grads"] = reference_tree(jax.grad(
        lambda p: ref_training.causal_lm_loss(cfg, p, jnp.asarray(tokens)))(
            bf_params))
    fstep = ref_training.make_train_step(cfg, optax.sgd(0.5))
    new, _, floss = fstep(bf_params, optax.sgd(0.5).init(bf_params),
                          jnp.asarray(tokens))
    out["full_loss"], out["full_after"] = float(floss), reference_tree(new)
    out["port_cfg"] = ModelConfig.from_fields(dataclasses.asdict(cfg))
    return out


def _port_params(pair, key="params"):
    tree = (reference_tree(pair[key]) if key == "params"
            else pair[key])
    return params_from_reference(tree, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_causal_lm_loss_matches_reference(pair, masked):
    """The loss, with and without a loss mask, within LOSS_TOL."""
    tokens = torch.from_numpy(pair["tokens"])
    mask = torch.from_numpy(pair["mask"]) if masked else None
    with torch.no_grad():
        got = float(causal_lm_loss(pair["port_cfg"], _port_params(pair),
                                   tokens, loss_mask=mask))
    want = pair["loss_masked" if masked else "loss"]
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_adapter_gradients_match_jax_grad(pair):
    """The port's adapter gradients (B2's and B4's backward through their
    plain versions) against ``jax.grad``, every slot's A and B within
    GRAD_TOL of the leaf's norm; the base gets none."""
    cfg, lc = pair["port_cfg"], LoraConfig(r=4, lora_alpha=8)
    params = _port_params(pair)
    ad = adapters_from_reference(pair["live"], device="cpu")
    for ab in ad.values():
        for t in ab.values():
            t.requires_grad_(True)
    loss = causal_lm_loss(cfg, attach_lora(params, ad, lc),
                          torch.from_numpy(pair["tokens"]))
    assert abs(loss.item() - pair["lora_loss"]) <= LOSS_TOL * pair[
        "lora_loss"]
    loss.backward()
    for slot, ab in ad.items():
        for k in ("a", "b"):
            err = _rel(ab[k].grad, pair["grads"][slot][k])
            assert err < GRAD_TOL, (slot, k, err)
    qkv = params["layers"]["qkv"]
    assert not qkv.data.requires_grad and qkv.data.grad is None


def test_five_qlora_adam_steps_match_reference(pair):
    """Five Adam steps from the same adapters: each step's loss within
    LOSS_TOL, and each leaf within ADAM_TOL of the distance the
    reference's moved, in a direction within ADAM_COS of it."""
    cfg, lc = pair["port_cfg"], LoraConfig(r=4, lora_alpha=8)
    params = _port_params(pair)
    ad = adapters_from_reference(pair["adapters"], device="cpu")
    step = make_qlora_train_step(cfg, functools.partial(torch.optim.Adam,
                                                        lr=LR), lc)
    opt = None
    tokens = torch.from_numpy(pair["tokens"])
    for want in pair["adam_losses"]:
        ad, opt, loss = step(ad, opt, tokens, params)
        assert abs(float(loss) - want) <= LOSS_TOL * want
    for slot, ab in ad.items():
        for k in ("a", "b"):
            start = pair["adapters"][slot][k]
            want = pair["adam_adapters"][slot][k]
            got = ab[k].detach().numpy()
            moved = np.linalg.norm(want - start)
            err = np.linalg.norm(got - want)
            cos = float(np.sum((got - start) * (want - start)) / (
                np.linalg.norm(got - start) * moved))
            assert err <= ADAM_TOL * moved and cos >= ADAM_COS, (
                slot, k, err / moved, cos)


def _leaves(port, *refs, path=""):
    """(path, port tensor, reference arrays...) for every tensor leaf of
    the port's tree, a QTensor by its ``data``."""
    if isinstance(port, dict):
        for k, v in port.items():
            yield from _leaves(v, *(r[k] for r in refs), path=f"{path}/{k}")
    elif isinstance(port, torch.Tensor) or hasattr(port, "qtype"):
        yield (path, port.data if hasattr(port, "qtype") else port,
               *(r["data"] if isinstance(r, dict) else r for r in refs))


def test_full_parameter_step_matches_reference(pair):
    """One SGD step on a bf16 model: the loss within LOSS_TOL; every
    trainable leaf, the layers' stacks included, with a gradient within
    GRAD_TOL of ``jax.grad``'s; the step within STEP_TOL of the
    reference's move for every fp32 leaf and for the embedding and head
    (bf16 both sides).  The layers' bf16 matrices are held by their
    gradients: rounding the stepped weights to bf16 on each side puts
    them 2.6-3.3% of the move apart (measured) at gradients 1.4-2.3%
    apart.  The rope table is untouched and gets no gradient."""
    cfg = pair["port_cfg"]
    params = params_from_reference(pair["bf16_params"], device="cpu")
    before = {k: v.detach().clone() for k, v in params.items()
              if isinstance(v, torch.Tensor)}
    step = make_train_step(cfg, functools.partial(torch.optim.SGD, lr=0.5))
    params, _, loss = step(params, None, torch.from_numpy(pair["tokens"]))
    assert abs(float(loss) - pair["full_loss"]) <= LOSS_TOL * pair[
        "full_loss"]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    held = []
    for path, got, start, want, grad in _leaves(
            params, pair["bf16_params"], pair["full_after"],
            pair["full_grads"]):
        if path == "/inv_freq":
            continue
        assert got.grad is not None, path
        err = _rel(got.grad.double().numpy(), grad)
        assert err < GRAD_TOL, (path, err)
        if got.dtype == torch.float32 or path in ("/embed", "/lm_head"):
            moved = np.linalg.norm(f32(want) - f32(start))
            err = np.linalg.norm(got.detach().float().numpy() - f32(want))
            assert moved > 0 and err <= STEP_TOL * moved + 1e-6, (
                path, err, moved)
        held.append(path)
    assert {"/layers/qkv", "/layers/o", "/layers/gate_up", "/layers/down",
            "/layers/attn_norm", "/layers/mlp_norm"} <= set(held)
    assert torch.equal(params["inv_freq"], before["inv_freq"])
    assert not params["inv_freq"].requires_grad


def test_lisa_masks_frozen_layers():
    """A LISA step moves only the active layers' stacked leaves; the
    embedding, head and final norm move too."""
    ref_cfg = tiny_cfg(vocab_size=61, hidden_size=32, intermediate_size=64,
                       num_heads=4, num_kv_heads=2, head_dim=8, num_layers=4)
    cfg = ModelConfig.from_fields(dataclasses.asdict(ref_cfg))
    params = params_from_reference(reference_tree(
        rand_params(ref_cfg, qtype="bf16")), device="cpu")
    mask = torch.tensor([True, False, False, True])
    before = params["layers"]["qkv"].data.detach().float().clone()
    emb = params["embed"].detach().clone()
    step = make_lisa_train_step(cfg, functools.partial(torch.optim.SGD,
                                                       lr=1e-2))
    params, _, loss = step(params, None, torch.from_numpy(
        _tokens(61, seed=3)), mask)
    after = params["layers"]["qkv"].data.detach().float()
    changed = (after - before).abs().reshape(4, -1).amax(dim=1) > 0
    assert torch.equal(changed, mask) and np.isfinite(float(loss))
    assert not torch.equal(params["embed"], emb)


@pytest.mark.parametrize("n_layers,n_active", [(8, 3), (4, 1), (32, 2)])
def test_sample_active_layers_count(n_layers, n_active):
    gen = torch.Generator().manual_seed(n_layers)
    for _ in range(5):
        m = sample_active_layers(gen, n_layers, n_active)
        assert m.dtype == torch.bool and int(m.sum()) == n_active


@pytest.mark.parametrize("qtype", ["sym_int4", "nf4", "fp4", "sym_int8",
                                   "sym_int5"])
def test_quantize_optimize_bitwise_the_reference(qtype):
    """``quantize(optimize=True)``, the scale search, bitwise the
    reference's jitted codec (a zero block and a padded tail included)."""
    rng = np.random.default_rng(7)
    for shape in ((96, 40), (200, 16)):
        w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
        w[:32, 3] = 0.0
        r = ref_qcore.quantize(w, qtype, optimize=True)
        p = port_qcore.quantize(torch.from_numpy(w), qtype, optimize=True)
        assert np.array_equal(np.asarray(r.data), p.data.numpy())
        assert np.array_equal(np.asarray(r.scales).view(np.uint16),
                              p.scales.numpy().view(np.uint16))


def test_quantize_imatrix_raises():
    with pytest.raises(NotImplementedError, match="item 13"):
        port_qcore.quantize(torch.zeros(64, 8), "sym_int4",
                            imatrix=torch.ones(64))


@pytest.mark.parametrize("qtype", ["sym_int4", "nf4", "fp4"])
def test_merge_lora_bitwise_the_reference(qtype):
    """``merge_lora``'s planes bitwise the reference's.  The adapters are
    multiples of 2^-9 with few terms, so every product and partial sum of
    ``A B`` is exact in fp32 and the delta does not depend on the two
    libraries' summation orders; the dequantize, the add and the scale
    search are then the same operations on the same bits."""
    cfg = tiny_cfg(vocab_size=89, hidden_size=64, intermediate_size=128,
                   num_heads=4, num_kv_heads=2, head_dim=16)
    ref_params = rand_params(cfg, qtype=qtype)
    lc = ref_training.LoraConfig(r=4, lora_alpha=8)
    rng = np.random.default_rng(3)
    adapters = {}
    for slot in lc.target_modules:
        qt = ref_params["layers"][slot]
        n_l, d_in, d_out = cfg.num_layers, qt.in_features, qt.out_features
        adapters[slot] = {
            "a": rng.integers(-8, 9, (n_l, d_in, 4)).astype(np.float32)
            / 512.0,
            "b": rng.integers(-8, 9, (n_l, 4, d_out)).astype(np.float32)
            / 512.0}
    ref = ref_training.merge_lora(ref_params, jax.tree_util.tree_map(
        jnp.asarray, adapters), lc)
    port = merge_lora(params_from_reference(reference_tree(ref_params),
                                            device="cpu"),
                      adapters_from_reference(adapters, device="cpu"),
                      LoraConfig(r=4, lora_alpha=8))
    for slot in lc.target_modules:
        r, p = ref["layers"][slot], port["layers"][slot]
        assert np.array_equal(np.asarray(r.data), p.data.numpy()), slot
        assert np.array_equal(np.asarray(r.scales).view(np.uint16),
                              p.scales.numpy().view(np.uint16)), slot
        assert p.data.shape[0] == cfg.num_layers


def test_lora_identity_at_init(pair):
    """B = 0 at init: the attached model's loss is the base's, bitwise."""
    cfg, lc = pair["port_cfg"], LoraConfig(r=4)
    params = _port_params(pair)
    ad = init_lora(torch.Generator().manual_seed(0), cfg, params, lc)
    assert all(float(ab["b"].abs().max()) == 0.0 for ab in ad.values())
    assert ad["qkv"]["a"].shape == (2, 32, 4)
    tokens = torch.from_numpy(pair["tokens"])
    with torch.no_grad():
        base = causal_lm_loss(cfg, params, tokens)
        lora = causal_lm_loss(cfg, attach_lora(params, ad, lc), tokens)
    assert float(base) == float(lora)


class _Model:
    """The model surface the trainers need."""

    def __init__(self, cfg, params):
        self.config, self.params, self.saved = cfg, params, None

    def save_low_bit(self, path):
        self.saved = path


def test_relora_merge_and_reset(pair):
    """Every ``relora_steps`` the adapters fold into the base (its planes
    change), start again from B = 0, and training goes on finitely."""
    cfg = pair["port_cfg"]
    model = _Model(cfg, _port_params(pair))
    planes0 = model.params["layers"]["qkv"].data.clone()
    tr = ReLoRATrainer(model, LoraConfig(r=4),
                       functools.partial(torch.optim.Adam, lr=1e-2),
                       relora_steps=5)
    tokens = _tokens(cfg.vocab_size, b=1, t=12, seed=11)
    l0 = tr.step(tokens)
    for _ in range(4):
        tr.step(tokens)            # the fifth step merges and resets
    assert tr.adapters["qkv"]["b"].abs().max().item() == 0.0
    assert not torch.equal(model.params["layers"]["qkv"].data, planes0)
    assert tr.opt_state.state == {}
    li = tr.step(tokens)
    assert np.isfinite(li) and li < l0 * 1.2


@pytest.mark.parametrize("step", [0, 3, 9, 10, 14, 25, 50, 99])
def test_jagged_cosine_matches_reference(step):
    want = float(ref_training.jagged_cosine_schedule(3e-4, 100, 10,
                                                     warmup=4)(step))
    got = jagged_cosine_schedule(3e-4, 100, 10, warmup=4)(step)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_checkpoint_resume_is_bitwise(pair, tmp_path):
    """Save after three steps, go on two (the gold run); restore into a
    fresh tree and optimizer and replay the two: the loss and adapters are
    bitwise the gold run's.  Keeps ``max_to_keep`` steps, writes each step
    whole under a temporary name."""
    cfg, lc = pair["port_cfg"], LoraConfig(r=4, lora_alpha=8)
    params = _port_params(pair)
    opt_fn = functools.partial(torch.optim.Adam, lr=1e-2)
    step = make_qlora_train_step(cfg, opt_fn, lc)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, b=1, t=16, seed=9))
    ad = init_lora(2, cfg, params, lc)
    opt = init_optimizer(opt_fn, ad)
    for _ in range(3):
        ad, opt, _ = step(ad, opt, tokens, params)
    ck = TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(s, ad, opt, extras={"note": f"r{s}"}, wait=True)
    assert ck.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2",
                                                                      "3"]
    for _ in range(2):
        ad, opt, gold = step(ad, opt, tokens, params)
    fresh = init_lora(5, cfg, params, lc)
    res = ck.restore({"params": fresh, "opt_state": init_optimizer(opt_fn,
                                                                   fresh)})
    assert res["extras"]["note"] == "r3"
    ad2, opt2 = res["params"], res["opt_state"]
    for _ in range(2):
        ad2, opt2, got = step(ad2, opt2, tokens, params)
    assert float(got) == float(gold)
    for slot in ad:
        assert torch.equal(ad[slot]["a"], ad2[slot]["a"])
    ck.close()


def _train_args(tmp_path):
    try:
        from transformers import TrainingArguments

        return TrainingArguments(
            output_dir=str(tmp_path / "out"), per_device_train_batch_size=4,
            num_train_epochs=2, learning_rate=5e-3, logging_steps=2,
            report_to=[])
    except Exception:  # minimal duck-typed args
        class Args:
            output_dir = str(tmp_path / "out")
            per_device_train_batch_size = 4
            num_train_epochs = 2
            learning_rate = 5e-3
            logging_steps = 2
        return Args()


def test_tpu_trainer_full_and_qlora(tmp_path, monkeypatch):
    """``TPUTrainer`` over HF ``TrainingArguments`` (where transformers is
    installed): full-parameter training memorises one sequence (labels
    -100 masked) and saves; the QLoRA path moves the adapters only."""
    from ipex_llm_tpu_torch.training import TPUTrainer

    monkeypatch.setenv("USE_TF", "0")      # keep TensorFlow out
    ref_cfg = tiny_cfg(vocab_size=97, hidden_size=32, intermediate_size=64,
                       num_heads=2, num_kv_heads=2, head_dim=16,
                       max_position_embeddings=128,
                       rope=RopeScaling(head_dim=16))
    cfg = ModelConfig.from_fields(dataclasses.asdict(ref_cfg))
    seq = list(np.random.default_rng(0).integers(0, 97, 24))
    data = [{"input_ids": seq, "labels": [-100] * 8 + seq[8:]}
            for _ in range(16)]
    args = _train_args(tmp_path)
    model = _Model(cfg, params_from_reference(reference_tree(
        rand_params(ref_cfg, qtype="bf16")), device="cpu"))
    tr = TPUTrainer(model, args=args, train_dataset=data)
    res = tr.train()
    assert res["global_step"] == 8
    losses = [r["loss"] for r in tr.state_log]
    assert losses[-1] < losses[0], losses
    assert model.saved is not None

    qmodel = _Model(cfg, params_from_reference(reference_tree(
        rand_params(ref_cfg, qtype="sym_int4")), device="cpu"))
    planes = qmodel.params["layers"]["qkv"].data.clone()
    peft = get_peft_model(qmodel, LoraConfig(r=4, lora_alpha=8))
    a0 = peft.adapters["qkv"]["a"].detach().clone()
    TPUTrainer(peft, args=args, train_dataset=data).train()
    assert torch.equal(qmodel.params["layers"]["qkv"].data, planes)
    assert not torch.allclose(a0, peft.adapters["qkv"]["a"])
    assert (tmp_path / "out" / "0" / "state.pt").exists()


def test_llm_patch_and_unpatch(monkeypatch):
    """``llm_patch(train=True)`` points transformers' Auto classes,
    ``LlamaForCausalLM`` and ``Trainer`` at the port (a port's model gets
    a ``TPUTrainer``); a second call is a no-op; ``llm_unpatch`` restores
    them, and also a ``patch_transformers_trainer`` made alone.
    (transformers may swap its lazy module in ``sys.modules`` while
    importing, so the module is looked up anew each time.)"""
    import importlib

    monkeypatch.setenv("USE_TF", "0")
    pytest.importorskip("transformers")
    from ipex_llm_tpu_torch import llm_patch, llm_unpatch
    from ipex_llm_tpu_torch.training.hf_trainer import TPUTrainer
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM

    def tf():
        return importlib.import_module("transformers")

    llm_patch(train=True)
    try:
        assert tf().AutoModelForCausalLM is AutoModelForCausalLM
        assert tf().LlamaForCausalLM is AutoModelForCausalLM
        assert isinstance(tf().Trainer(PeftModel.__new__(PeftModel)),
                          TPUTrainer)
        llm_patch()                 # a second call is a no-op
        assert tf().AutoModelForCausalLM is AutoModelForCausalLM
    finally:
        llm_unpatch()
    assert tf().AutoModelForCausalLM is not AutoModelForCausalLM
    assert not isinstance(tf().Trainer, type) or \
        tf().Trainer.__module__.startswith("transformers")
    from ipex_llm_tpu_torch.training import patch_transformers_trainer

    orig = patch_transformers_trainer()
    try:
        assert tf().Trainer is not orig
        assert isinstance(tf().Trainer(PeftModel.__new__(PeftModel)),
                          TPUTrainer)
    finally:
        llm_unpatch()
    assert tf().Trainer is orig


def test_serving_paths_build_no_graph(monkeypatch):
    """``generate()``, ``__call__`` and an engine's ticks enter neither
    autograd Function (both are made to raise) and return tensors with no
    ``grad_fn``, even with gradients enabled and after a full-parameter
    step has left the params requiring grad."""
    from ipex_llm_tpu_torch.models.random_init import (llama_config,
                                                       random_params)
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    def refuse(*a, **kw):
        raise AssertionError("an autograd Function was entered")
    cfg = llama_config(hidden_size=64, intermediate_size=160, num_layers=2,
                       num_heads=4, num_kv_heads=2, vocab_size=256,
                       head_dim=16)
    params = random_params(cfg, "sym_int4", seed=1, device="cpu")
    model = TPUModelForCausalLM(cfg, params, {}, "sym_int4")
    make_train_step(cfg, functools.partial(torch.optim.SGD, lr=1e-3))(
        params, None, torch.from_numpy(_tokens(cfg.vocab_size)))
    assert params["embed"].requires_grad
    monkeypatch.setattr(port_linear._QMatmul, "apply", refuse)
    monkeypatch.setattr(port_attention._FlashAttention, "apply", refuse)
    assert torch.is_grad_enabled()
    logits = model(np.array([[5, 9, 12, 4]]))
    assert logits.grad_fn is None
    out = model.generate(np.array([[5, 9, 12]]), max_new_tokens=3)
    assert np.asarray(out).shape == (1, 6)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_rows=2, max_seq_len=128, page_size=16, prefill_bucket=32),
        device="cpu")
    req = eng.submit(Request(prompt_ids=[1, 5, 9], max_new_tokens=3))
    while req.finish_reason is None:
        eng._tick()
    assert len(req.output_ids) == 3


def test_grad_paths_outside_the_slice_raise():
    """Under a gradient a window, a softcap (and a bias) raise, naming
    the ROADMAP item; without one they run as before."""
    q = torch.randn(1, 8, 2, 16, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, dtype=torch.bfloat16)
    for kw in ({"window": 4}, {"softcap": 30.0}):
        with pytest.raises(NotImplementedError, match="item 16"):
            port_attention.sdpa(q, k, k, **kw)
        with torch.no_grad():
            assert port_attention.sdpa(q, k, k, **kw).shape == q.shape
    from ipex_llm_tpu_torch.quantize.core import quantize

    qt = quantize(torch.randn(2, 64, 32).reshape(128, 32), "sym_int4")
    stack = qt.planes(lambda t: t.reshape(2, -1, t.shape[-1]))
    stack.shape = (64, 32)
    x = torch.randn(3, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 16"):
        port_linear.qmatmul_experts(x, torch.tensor([0, 2, 3]), stack)


def test_adapters_from_reference_bitwise(pair):
    ad = adapters_from_reference(pair["adapters"], device="cpu")
    for slot, ab in pair["adapters"].items():
        for k in ("a", "b"):
            assert ad[slot][k].dtype == torch.float32
            assert np.array_equal(ad[slot][k].numpy(), ab[k])
