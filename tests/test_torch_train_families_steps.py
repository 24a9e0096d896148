"""Three steps of ``build_train_step`` for the VLM, enc-dec, RWKV6 and
Zamba2 families in the port against the JAX package's ``build_train_step``
on a (1, 1) mesh (CPU), with and without gradient accumulation, from the
same train state (``train_state_from_jax``), on the batches and under the
tolerances of ``tests/test_torch_train_families.py`` (see its docstring).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.launch.mesh import make_mesh
from repro.runtime.optimizer import Optimizer as JaxOptimizer
from repro.runtime.optimizer import OptimizerConfig as JaxConfig
from repro.runtime.steps import build_train_step as jax_build_train_step
from repro.utils.tree import tree_flatten_with_paths as jax_paths
from repro_torch.configs import ShapeConfig
from repro_torch.models import train_state_from_jax
from repro_torch.runtime.optimizer import OptimizerConfig
from repro_torch.runtime.steps import build_train_step
from repro_torch.utils import tree_flatten_with_paths
from test_torch_train_families import ARCHS, B, GRAD_TOL, KW, _batch, _jax, _jax_pair, _positions

torch.set_num_threads(1)

# the chained steps' tolerances (the metrics relative, each leaf's update
# over its norm, each moment over the leaf's largest |value|): 1e-5, 1e-3
# and 1e-3 by default. RWKV6's and Zamba2's f32 steps drift apart from an
# f64 evaluation of the same three steps in either package (tests/
# grad_precision.py --steps, one thread as here): rwkv6 up to 6.6e-5 and
# 1.7e-4 in the grad norm, 7.9e-4 and 3.0e-3 in an update, 7.1e-4 and
# 2.3e-3 in a moment (the port and the JAX package); zamba2 up to 1.5e-5 and
# 1.8e-6 in the loss, 9.1e-5 and 1.3e-5 in the grad norm, 2.0e-2 and 7.5e-4
# in an update, 1.3e-2 and 1.4e-3 in a moment, all at its third step, after
# one element whose moment lay within 1.1e-6 of its leaf's largest took the
# other sign of an Adam step at the second (the port's embed[456, 15], 8.9e-4
# from f64; the JAX package's shared/wo[123, 88]). Two packages each that far
# from f64 may differ by the sum.
STEP_TOL = {"rwkv6-3b": {"metric": 2e-4, "update": 4e-3, "moment": 3e-3},
            "zamba2-1.2b": {"metric": 1.2e-4, "update": 2.5e-2, "moment": 2e-2}}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, accum):
    """With ``grad_accum`` 2 every batch key, the stub embeddings too, is
    cut into microbatches along its rows with the tokens. The three steps
    are chained in each package from the same state."""
    tol = STEP_TOL.get(arch, {"metric": 1e-5, "update": 1e-3, "moment": 1e-3})
    jm, jp, tm = _jax_pair(arch)
    first = _batch(tm.cfg, 10)
    mesh = make_mesh((1, 1), ("data", "model"))
    bundle = jax_build_train_step(jm, mesh, JaxShape("t", _positions(first), B, "train"),
                                  JaxConfig(**KW), grad_accum=accum, donate=False)
    jfn = bundle.fn
    # placed as the step places its outputs, so that its second call does not compile again
    jp, js = jax.device_put((jp, JaxOptimizer(JaxConfig(**KW)).init(jp)), bundle.in_shardings[:2])
    state = train_state_from_jax(jax.tree.map(np.asarray, {"params": jp, "opt": js}), "cpu")
    fn = build_train_step(tm, ShapeConfig("t", _positions(first), B, "train"),
                          OptimizerConfig(**KW), grad_accum=accum, device="cpu")
    tp, to = state["params"], state["opt"]
    lr_sum = 0.0
    for step in range(3):
        batch = _batch(tm.cfg, 10 + step)
        before_t = {p: x.clone() for p, x in tree_flatten_with_paths(tp)}
        before_j = dict(jax_paths(jax.tree.map(np.asarray, jp)))
        jp, js, jmet = jfn(jp, js, _jax(batch))
        tp, to, tmet = fn(tp, to, batch)
        assert sorted(tmet) == sorted(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=tol["metric"],
                                       err_msg=k)
        lr_sum += float(jmet["lr"])
        moments = dict(jax_paths(jax.tree.map(np.asarray, js["m"])))
        for (path, a), (_, b) in zip(tree_flatten_with_paths(tp), jax_paths(jp)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2 * lr_sum, err_msg=path)
            du, dj = a.numpy() - before_t[path].numpy(), b - before_j[path]
            # Adam steps an element whose gradients lie within the packages'
            # f32 difference of zero by about lr in either sign: where that
            # difference is above 1e-5 (GRAD_TOL), such elements are held by
            # the 2 lr bound above only
            m = np.abs(moments[path])
            live = m > GRAD_TOL[arch] * m.max() if arch in GRAD_TOL else np.ones_like(m, bool)
            assert np.linalg.norm((du - dj)[live]) <= tol["update"] * np.linalg.norm(dj), path
        assert int(to["step"]) == int(js["step"]) == step + 1
        for (path, a), (_, b) in zip(tree_flatten_with_paths(to), jax_paths(js)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol["moment"] * float(
                np.abs(b).max(initial=0)), err_msg=path)
