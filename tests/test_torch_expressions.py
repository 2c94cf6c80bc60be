"""The port's Lepton expression compiler against the JAX package's.

Every expression of tests/test_expressions.py, the reference's default
alchemical functions, the ethylene system's custom pair energy and one
expression through every function, evaluated by
``blues_tpu_torch.core.expressions`` on float64 tensors (or Python floats)
and by ``blues_tpu.core.expressions`` under ``jax.enable_x64``: values
agree to 1e-12 relative, gradients (torch autograd against ``jax.grad``
of the sum) to 1e-10 relative to the largest. The inputs stay off the
kinks of abs, min/max, step, floor and ceil, where the two frameworks may
pick different subgradients. Errors (an unknown variable, an unknown
function, unresolvable definitions, parse errors) raise the same types
with the same messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blues_tpu.core import expressions as jx
from blues_tpu.integrators import schedules as j_sched
from blues_tpu.testsystems import ETHYLENE_ENERGY
from blues_tpu_torch.core import expressions as tx
from blues_tpu_torch.integrators import schedules as t_sched

import _torch_helpers  # noqa: F401  (one intra-op thread per worker)

_R = np.linspace(0.31, 1.7, 7)
_X = np.array([0.13, 0.27, 0.44, 0.58, 0.91])

CASES = {
    # the reference's defaults, at master lambdas off their kinks (0.2,
    # 0.35, 0.5, 0.65, 0.8)
    "sterics": (t_sched.DEFAULT_ALCHEMICAL_FUNCTIONS["lambda_sterics"], {"lambda": np.array([0.05, 0.3, 0.45, 0.7, 0.95])}),
    "electrostatics": (
        t_sched.DEFAULT_ALCHEMICAL_FUNCTIONS["lambda_electrostatics"],
        {"lambda": np.array([0.05, 0.15, 0.5, 0.85, 0.97])},
    ),
    "definitions": ("a + b; a = x^2; b = a + 1", {"x": np.array([3.0, -1.5])}),
    "precedence": ("2*x^2 + 1", {"x": np.array([3.0, 0.4])}),
    "unary_minus": ("-x^2", {"x": np.array([2.0, -0.7])}),
    "select": ("select(step(x), sqrt(4), exp(0)) * x", {"x": np.array([1.0, -1.0, 0.3])}),
    "vectorized": ("q1*q2/r^2", {"q1": np.array(2.0), "q2": np.array(3.0), "r": _R}),
    "lj": ("4*epsilon*((sigma/r)^12-(sigma/r)^6)", {"epsilon": np.array(0.6), "sigma": np.array(0.32), "r": _R}),
    "ethylene": (
        ETHYLENE_ENERGY,
        {
            "r": _R[:, None],
            "sigma1": np.array([0.325, 0.31]), "sigma2": np.array([0.408]),
            "epsilon1": np.array([0.711, 0.5]), "epsilon2": np.array([0.36]),
            "q1": np.array([-0.2, -0.5]), "q2": np.array([1.0]),
            "lambda_sterics": np.array(0.7), "lambda_electrostatics": np.array(0.4), "lambda_charge": np.array(1.0),
        },
    ),
    "functions": (
        "erf(x) + erfc(x) + tanh(x) + sinh(x) + cosh(x) + log(x) + exp(-x) + atan(x) + asin(x/2)"
        " + acos(x/3) + tan(x) + cos(x) + sin(x) + sqrt(x) + floor(3*x) + ceil(3*x) + delta(x-0.44)"
        " + max(x, 0.35) + min(x, 0.7) + x^0.5 + x^(1/3) + x^-3 + abs(x-0.5) + pi*x",
        {"x": _X},
    ),
}


@pytest.mark.parametrize("name", list(CASES))
def test_values_and_gradients_match_jax_f64(name):
    text, env = CASES[name]
    et = tx.compile_expression(text)
    assert et.variables == jx.compile_expression(text).variables == set(env)
    with jax.enable_x64(True):
        ej = jx.compile_expression(text)
        keys = sorted(env)

        def total(*vals):
            return jnp.sum(ej(dict(zip(keys, vals))))

        vals_j = [jnp.asarray(env[k], jnp.float64) for k in keys]
        v_j = np.asarray(ej(dict(zip(keys, vals_j))))
        g_j = [np.asarray(g) for g in jax.grad(total, argnums=tuple(range(len(keys))))(*vals_j)]
    vals_t = [torch.as_tensor(env[k], dtype=torch.float64).requires_grad_(True) for k in keys]
    out = et(dict(zip(keys, vals_t)))
    g_t = torch.autograd.grad(out.sum(), vals_t, allow_unused=True)
    v_t = out.detach().numpy()
    np.testing.assert_allclose(v_t, np.broadcast_to(v_j, v_t.shape), rtol=1e-12, atol=0)
    scale = max(float(np.abs(g).max()) for g in g_j)
    for k, a, b in zip(keys, g_t, g_j):
        a = np.zeros_like(b) if a is None else a.numpy()
        assert float(np.abs(a - b).max()) <= 1e-10 * scale, (name, k, a, b)


@pytest.mark.parametrize("lam", [0.0, 0.1, 0.35, 0.5, 0.65, 0.9, 1.0])
def test_schedule_functions_take_python_floats(lam):
    """The schedule evaluates its strings at a float lambda: the port
    gives the JAX value (x64) as a float64 number, kinks included."""
    with jax.enable_x64(True):
        for k, text in j_sched.DEFAULT_ALCHEMICAL_FUNCTIONS.items():
            assert t_sched.DEFAULT_ALCHEMICAL_FUNCTIONS[k] == text
            vj = float(j_sched.as_schedule_fn(text)(lam))
            vt = t_sched.as_schedule_fn(text)(lam)
            assert vt.dtype == torch.float64 and float(vt) == pytest.approx(vj, rel=1e-15, abs=1e-15)
    assert float(tx.compile_expression("max(2, 3) - min(1, 0.5) + abs(-2)")({})) == 4.5


ERRORS = {
    "unknown_variable": ("4*epsilon*((sigma/r)^12-(sigma/r)^6)", {"sigma": 1.0, "r": 1.0}),
    "unknown_function": ("bogusfn(x)", {"x": 1.0}),
    "unresolvable": ("a + 1; a = b * 2; b = a - c", {"c": 1.0}),
    "parse_operator": ("2 +* 3", None),
    "parse_paren": ("(1 + 2", None),
    "parse_trailing": ("1 2", None),
    "tokenize": ("x $ 2", None),
    "empty": (" ; ", None),
    "assignment": ("a; b", None),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_match_jax(name):
    text, env = ERRORS[name]

    def run(mod):
        try:
            expr = mod.compile_expression(text)
            expr(env)
        except (KeyError, ValueError) as e:
            return type(e), str(e)
        return None

    ej, et = run(jx), run(tx)
    assert ej is not None and et == ej


def test_schedule_string_with_another_variable_raises_as_jax():
    for mod in (j_sched, t_sched):
        with pytest.raises(ValueError, match="unknown variables"):
            mod.as_schedule_fn("lambda * k")
