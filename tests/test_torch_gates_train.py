"""The port's learning gates at CPU size (``scripts/overfit_dock_torch.py``,
``scripts/check_train_numerics_torch.py``, ``scripts/learns_to_dock_torch.py``).

The full runs go on the card and commit ``docs/artifacts/*_h100.json``.
Here: each harness's ``--smoke --device cpu`` run completes and writes an
artifact with the JAX artifact's keys plus ``card`` and ``device``; part
A's production irreps specs are the JAX harness's, and at a small M the
port's differentiable edge op holds against the JAX package's
``fused_tpconv_train`` in interpret mode at each of them (none of the
three is among ``tests/test_torch_train_ops.py``'s specs, which are
narrower); the learns-to-dock harness's toy complex is the JAX tests'.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from confidence_bootstrapping_tpu.ops.pallas import tpconv_train as jtpt
from test_bootstrapping import _synthetic_target
from test_torch_common import install_jax_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import check_train_numerics  # noqa: E402
import check_train_numerics_torch  # noqa: E402
import learns_to_dock_torch  # noqa: E402
import overfit_dock_torch  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "docs", "artifacts")
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
ARGS = ("edge_attr", "sender", "sh", "w1", "b1", "w2", "b2")


def jax_keys(name: str) -> set:
    with open(os.path.join(ARTIFACTS, name)) as f:
        return set(json.load(f))


def test_numerics_specs_are_the_jax_specs():
    from confidence_bootstrapping_tpu.ops.irreps import Irreps as JIrreps
    from confidence_bootstrapping_tpu_torch.ops.irreps import Irreps

    got = check_train_numerics_torch.specs()
    want = check_train_numerics._specs()
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert [str(Irreps(a)) for a in g[1:4]] == [str(JIrreps(a)) for a in w[1:4]] and g[4] == w[4]


@pytest.mark.parametrize("spec", [s[0] for s in check_train_numerics._specs()])
def test_numerics_spec_matches_jax_interpret(spec):
    """Part A's op at one production spec, M=6 lists of K=4, H=16: the
    port's ``fused_tpconv_train`` on the CPU (its plain composition) against
    the JAX package's in interpret mode, forward and every gradient, on the
    harness's seeded inputs."""
    name, irin, irsh, irout, with_dmask = next(s for s in check_train_numerics_torch.specs() if s[0] == spec)
    x = check_train_numerics_torch.op_inputs(irin, irsh, irout, with_dmask, M=6, K=4, H=16, Fe=12)

    def jax_loss(*xs):
        a = dict(zip(ARGS, xs))
        out = jtpt.fused_tpconv_train(a["edge_attr"], a["sender"], a["sh"], jnp.asarray(x["mask"]), a["w1"], a["b1"],
                                      a["w2"], a["b2"], irin, irsh, irout,
                                      dmask=None if x["dmask"] is None else jnp.asarray(x["dmask"]), sum_k=True,
                                      use_bf16=False, interpret=True)
        return jnp.sum(out * x["cot"]), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(x[n]) for n in ARGS))
    got = check_train_numerics_torch.op_run(x, (irin, irsh, irout), torch.device("cpu"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **FWD_TOL)
    for n, g, w in zip(ARGS, got[1:], jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=n, **GRAD_TOL)


def test_synthetic_target_is_the_jax_one():
    from confidence_bootstrapping_tpu_torch.data.complex_graph import pad_complex

    for seed, kw in ((0, {}), (3, dict(all_atoms=True))):
        jt = _synthetic_target("AAAA_1", seed, **kw)
        pt = learns_to_dock_torch.synthetic_target("AAAA_1", seed, **kw)
        assert tuple(pt.bucket) == tuple(jt.bucket)
        want = jt.padded
        got = pad_complex(pt.hc, pt.bucket, lm_dim=16)
        assert set(got) == set(k for k in want if want[k] is not None)
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


def test_overfit_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "overfit.json"
    overfit_dock_torch.main(["--smoke", "--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert jax_keys("overfit_dock_tpu.json") | {"card", "device"} <= set(art)
    assert set(art["rmsd"]) == {"untrained", "trained", "ema"} and art["phase_plan"] == [[8, 256]]
    assert art["train_steps"] == 3 and all(np.isfinite(r["loss"]) for r in art["loss_trajectory"])


def test_numerics_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "numerics.json"
    check_train_numerics_torch.main(["--smoke", "--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert jax_keys("train_numerics_tpu.json") | {"card", "device"} <= set(art)
    assert set(art["op_backward_parity"]) == {"cg_trunk_l1", "torsion_head", "aa_trunk_l2"}
    assert all(r["ok"] for r in art["op_backward_parity"].values())
    tj = art["trajectory"]
    # both arms on the CPU draw the same numbers from their CPU generators: the same trajectory
    assert tj["losses_plain"] == tj["losses_kernel"] and tj["evals_plain"] == tj["evals_kernel"]
    assert len(tj["evals_plain"]) == 3


def test_learns_to_dock_smoke_writes_the_artifact(tmp_path, monkeypatch):
    install_jax_tables(monkeypatch)
    out = tmp_path / "learns.json"
    learns_to_dock_torch.main(["--smoke", "--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert {"overfit", "cb", "rerank", "asserts", "card", "device"} <= set(art)
    assert set(art["asserts"]) == {"overfit", "cb", "rerank"} and len(art["cb"]["rounds"]) == 2

