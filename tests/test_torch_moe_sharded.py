"""The port's MoE with expert parallelism on a DTensor mesh of real ranks:
a ``gloo`` group of 4 CPU processes (``spawn_workers``) holding a 2 × 2
``(data, model)`` ``DeviceMesh``, the weights (the JAX package's
``init_lm`` through ``lm_params_from_jax``) placed by ``param_spec``,
the tokens by ``batch_spec``.  Inside ``activation_sharding`` each rank
routes, dispatches and combines its own token group, the router counts
of the aux loss are summed over ``data``, and the dispatch buffer moves
group-sharded -> expert-sharded -> group-sharded around the experts.

The workers' function lives in ``tests/torch_dist_cases.py``
(``run_moe_case``); this process runs the same function on plain tensors
inside the same mesh's context (an ``AbstractMesh``, so ``G = 2`` token
groups), on one thread while the group runs, and the JAX package's model
with ``repro.models.moe.dispatch_groups`` set to return 2 (no JAX mesh is
active, so JAX's ``maybe_shard`` is the identity).  All in f32:

* qwen2-moe-a2.7b smoke: the MoE FFN (also at capacity factor 0.5, so
  choices are dropped), the training forward's hidden states, ``lm_loss``
  (loss, CE, aux) and its gradients;
* llama4-maverick and jamba-1.5-large smoke: the MoE FFN;
* qwen2-moe smoke: a batch-1 decode step with vocab-sharded logits, its
  cache from a plain prefill laid out by the dry run's ``cache_rule``.

Outputs, losses and logits within 1e-5 of their largest magnitude;
gradients within 1e-5 of each leaf's norm; every expert choice and the
greedy token exactly equal.  The seed's smallest top-k margin is printed,
so a tie would be seen, not hidden.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.launch.steps import make_decode_step as j_decode_step
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.dist import gnn_parallel as gp
from repro_torch.dist.sharding import AbstractMesh
from repro_torch.models.moe import group_capacity

import torch_dist_cases as cases

Q, TOL = 4, 1e-5
QWEN, LLAMA, JAMBA = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
                      "jamba-1.5-large-398b")
FFN_CASES = {"qwen2_ffn": (QWEN, None), "qwen2_ffn_cf05": (QWEN, 0.5),
             "llama4_ffn": (LLAMA, None), "jamba_ffn": (JAMBA, None)}
SEED = 17


def _params_np(arch: str):
    jc = jget(arch, smoke=True)
    jp = jax.jit(JT.init_lm, static_argnums=1)(jax.random.key(3), jc)
    return jax.tree_util.tree_map(np.asarray, jp)


def _jcfg(case: dict):
    """The JAX package's config of ``case`` (:func:`cases.moe_case_config`'s
    counterpart)."""
    jc = jget(case["arch"], smoke=True)
    if case.get("capacity_factor"):
        jc = jc.with_(moe=dataclasses.replace(
            jc.moe, capacity_factor=case["capacity_factor"]))
    return jc


def _moe_layer(jc, blocks):
    """The first MoE layer's parameters of the stacked ``blocks``."""
    pi = next(i for i in range(len(jc.pattern)) if jc.layer_uses_moe(i))
    return jax.tree_util.tree_map(lambda t: t[0], blocks)[
        f"p{pi}_{jc.pattern[pi]}"]["moe"]


def _cases() -> dict:
    rng = np.random.default_rng(SEED)
    out = {}
    for name, (arch, cf) in FFN_CASES.items():
        d = jget(arch, smoke=True).d_model
        out[name] = {"arch": arch, "kind": "ffn", "capacity_factor": cf,
                     "params_np": _params_np(arch),
                     "x": rng.normal(size=(4, 8, d)).astype(np.float32)}
    vocab = jget(QWEN, smoke=True).vocab_size
    out["qwen2_lm"] = {"arch": QWEN, "kind": "lm",
                       "params_np": out["qwen2_ffn"]["params_np"],
                       "tokens": rng.integers(0, vocab, (4, 16))
                       .astype(np.int64)}
    out["qwen2_decode"] = {"arch": QWEN, "kind": "decode",
                           "params_np": out["qwen2_ffn"]["params_np"],
                           "prompt": rng.integers(0, vocab, (1, 8))
                           .astype(np.int64),
                           "next": rng.integers(0, vocab, (1, 1))
                           .astype(np.int64)}
    return out


def _plain_runs(all_cases: dict) -> dict:
    """Every case on plain tensors inside the mesh's context."""
    shape, names = cases.MOE_MESH
    mesh = AbstractMesh(shape, names)
    with cases.one_thread():
        return {name: cases.run_moe_case(case, mesh, lambda t, spec: t)
                for name, case in all_cases.items()}


def _jax_runs(all_cases: dict) -> dict:
    """The JAX package's results of every case at 2 dispatch groups."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "dispatch_groups", lambda: 2)
        return {name: _jax_case(case) for name, case in all_cases.items()}


@pytest.fixture(scope="module")
def all_cases():
    return _cases()


@pytest.fixture(scope="module")
def runs(all_cases):
    """The group's records, and the plain and JAX references computed in
    this process while the group's workers run."""
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(gp.spawn_workers, cases.moe_sharded_cases, Q,
                            all_cases, device="cpu", timeout=120.0)
        plain = _plain_runs(all_cases)
        jax_out = _jax_runs(all_cases)
        return group.result(), plain, jax_out


@pytest.fixture(scope="module")
def sharded(runs):
    return runs[0]


@pytest.fixture(scope="module")
def plain(runs):
    return runs[1]


@pytest.fixture(scope="module")
def jax_out(runs):
    return runs[2]


def _jax_case(case: dict) -> dict:
    jc = _jcfg(case)
    jp = jax.tree_util.tree_map(jnp.asarray, case["params_np"])
    if case["kind"] == "ffn":
        y, aux = JM.moe_ffn(_moe_layer(jc, jp["blocks"]), jc,
                            jnp.asarray(case["x"]))
        return {"out": np.asarray(y), "aux": float(aux)}
    if case["kind"] == "lm":
        batch = {"tokens": jnp.asarray(case["tokens"], jnp.int32)}
        h, _ = JT.forward_train(jp, jc, batch)
        (loss, parts), grads = jax.value_and_grad(
            lambda p: JT.lm_loss(p, jc, batch), has_aux=True)(jp)
        return {"hidden": np.asarray(h), "loss": float(loss),
                "ce": float(parts["ce"]), "moe_aux": float(parts["moe_aux"]),
                "grads": [np.asarray(g) for g in
                          jax.tree_util.tree_leaves(grads)]}
    prompt = jnp.asarray(case["prompt"], jnp.int32)
    _, cache = JT.prefill(jp, jc, {"tokens": prompt},
                          max_len=prompt.shape[1] + 4)
    tok, logits, _ = j_decode_step(jc)(
        jp, {"tokens": jnp.asarray(case["next"], jnp.int32)}, cache)
    return {"token": np.asarray(tok), "logits": np.asarray(logits)}


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _assembled(parts: list, n_rows: int) -> list:
    """Each ``route`` call's expert indices over all tokens, from every
    rank's ``(coordinate, choices)``: the data ranks' rows in order (model
    ranks hold the same rows, and agree), or one replicated copy (a
    single group)."""
    by_coord = {tuple(c): ch for c, ch in parts}
    calls = []
    for i in range(len(parts[0][1])):
        rows = {c: ch[i] for c, ch in by_coord.items()}
        first = next(iter(rows.values()))
        for (d, m), t in rows.items():
            assert torch.equal(t, rows[(d, 0)]), ("model ranks differ", d, m)
        if first.shape[0] == n_rows:
            assert all(torch.equal(t, first) for t in rows.values())
            calls.append(first)
        else:
            calls.append(torch.cat([rows[(d, 0)] for d in range(2)]))
    return calls


def _top_k_margin(case: dict) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    probability over the case's MoE inputs (JAX's router on the same
    input: a tie would make the choice depend on the rounding)."""
    jc = _jcfg(case)
    router = _moe_layer(jc, case["params_np"]["blocks"])["router"]
    x = jnp.asarray(case["x"]).reshape(-1, jc.d_model)
    probs = np.sort(np.asarray(jax.nn.softmax(x @ jnp.asarray(router),
                                              axis=-1)), -1)
    k = jc.moe.top_k
    return float((probs[:, -k] - probs[:, -k - 1]).min())


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_sharded_moe_ffn(all_cases, sharded, plain, jax_out, name):
    got, ref, want = sharded[name], plain[name], jax_out[name]
    margin = _top_k_margin(all_cases[name])
    print(f"{name}: smallest top-k margin {margin:.3e}")
    _close(got["out"], ref["out"], what="vs plain")
    _close(got["out"], want["out"], what="vs JAX")
    np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]),
                               rtol=TOL, atol=0)
    np.testing.assert_allclose(float(got["aux"]), want["aux"], rtol=TOL,
                               atol=0)
    n_tok = all_cases[name]["x"].shape[0] * all_cases[name]["x"].shape[1]
    calls = _assembled(got["choices"], n_tok)
    assert len(calls) == len(ref["choices"]) == 1
    # each data rank routed its own half of the tokens
    assert got["choices"][0][1][0].shape[0] == n_tok // 2
    assert torch.equal(calls[0], ref["choices"][0]), f"margin {margin}"


def test_sharded_moe_drops_choices(all_cases, plain):
    """The capacity-0.5 case drops choices (the overflow path runs)."""
    m = cases.moe_case_config(all_cases["qwen2_ffn_cf05"]).moe
    idx = plain["qwen2_ffn_cf05"]["choices"][0].reshape(2, -1)
    cap = group_capacity(m, idx.shape[1] // m.top_k)
    counts = torch.stack([torch.bincount(g, minlength=m.n_experts)
                          for g in idx])
    assert int(counts.max()) > cap


def test_sharded_lm_forward_loss_and_grads(all_cases, sharded, plain,
                                           jax_out):
    got, ref, want = (r["qwen2_lm"] for r in (sharded, plain, jax_out))
    _close(got["hidden"], ref["hidden"], what="hidden vs plain")
    _close(got["hidden"], want["hidden"], what="hidden vs JAX")
    for k in ("loss", "ce", "moe_aux"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=TOL,
                                   atol=0, err_msg=k)
        np.testing.assert_allclose(float(got[k]), want[k], rtol=TOL,
                                   atol=0, err_msg=k)
    assert float(got["moe_aux"]) > 0
    n_tok = all_cases["qwen2_lm"]["tokens"].size
    calls = _assembled(got["choices"], n_tok)
    assert len(calls) == len(ref["choices"]) == 2           # two layers
    for a, b in zip(calls, ref["choices"]):
        assert torch.equal(a, b)
    assert len(got["grads"]) == len(ref["grads"]) == len(want["grads"])
    for i, (g, r, w) in enumerate(zip(got["grads"], ref["grads"],
                                      want["grads"])):
        for other, what in ((r, "plain"), (w, "JAX")):
            other = np.asarray(other, np.float32)
            err = float(np.linalg.norm(g.numpy() - other))
            assert err <= TOL * max(float(np.linalg.norm(other)), 1e-30), \
                (i, what, err)


def test_sharded_batch1_decode_token(sharded, plain, jax_out):
    got, ref, want = (r["qwen2_decode"] for r in (sharded, plain, jax_out))
    assert got["token"].dtype == torch.int32
    assert torch.equal(got["token"], ref["token"])
    np.testing.assert_array_equal(got["token"].numpy(), want["token"])
    assert int(got["token"][0]) == int(ref["logits"][0].argmax())
    _close(got["logits"], ref["logits"], what="logits vs plain")
    _close(got["logits"], want["logits"], what="logits vs JAX")
    logits = np.sort(ref["logits"][0].numpy())
    print(f"decode: top-2 logit margin {logits[-1] - logits[-2]:.3e}")
    # batch 1: one token, one replicated group on every rank, two layers
    calls = _assembled(got["choices"], 1)
    assert len(calls) == len(ref["choices"]) == 2
    for a, b in zip(calls, ref["choices"]):
        assert torch.equal(a, b)
