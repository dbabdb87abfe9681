"""The port's ambient numerics route: ``numerics.use`` and the free
``matmul``/``qk``/``pv``/``elementwise`` ops, the counterparts of
``tests/test_numerics.py:110-180``, plus the same calls against the JAX
reference's under the same policy and the context's thread locality.

Bars: the reference's own (``exact`` within rtol 1e-6 of a plain matmul,
``lax_ref`` under ``use`` bit-equal to ``euler_matmul``, and the other
free ops to their engine functions); ``N.matmul`` against JAX's within
rtol 1e-5, atol 1e-4 (``tests/test_kernels.py:72``).
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as JN
from repro.core import engine as JE
from repro_torch import numerics as N
from repro_torch.core import engine as TE
from repro_torch.core.engine import EulerConfig, euler_matmul, from_variant

torch.set_num_threads(1)

P8 = from_variant(8, "L-21b")
P16 = from_variant(16, "L-21b")
EX = EulerConfig(mode="exact")


def _t(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def test_backend_registry_and_custom_backend_under_use():
    assert set(N.available_backends()) >= {"exact", "lax_ref", "cuda"}
    assert "pallas" not in N.available_backends()
    with pytest.raises(KeyError):
        N.get_backend("no_such_backend")

    class Doubler(N.Backend):
        def dot_general(self, a, b, dn, cfg):
            from repro_torch.core.engine import dot_general
            return 2 * dot_general(a, b, dn)

        def elementwise(self, a, b, cfg):
            return 2 * a * b

    import repro_torch.numerics.backends as B
    try:
        N.register_backend("doubler", Doubler())
        with N.use(EX, backend="doubler"):
            out = N.matmul(torch.ones((2, 3)), torch.ones((3, 4)))
            el = N.elementwise(torch.ones(3), torch.full((3,), 2.0))
        np.testing.assert_allclose(out.numpy(), 6.0)
        np.testing.assert_allclose(el.numpy(), 4.0)
    finally:
        B._BACKENDS.pop("doubler", None)


def test_use_and_scope_nesting():
    pol = N.PrecisionPolicy.uniform(P16).with_rule("outer/inner", P8)
    assert N.current() is N.DEFAULT
    with N.use(pol) as nctx:
        assert N.current() is nctx
        with N.scope("outer"):
            assert N.current_path() == "outer"
            with N.scope("inner"):
                assert N.current_path() == "outer/inner"
                assert N.resolve("matmul") == P8
            assert N.resolve("matmul") == P16
        with N.use(P8) as inner:
            assert N.current() is inner
        assert N.current() is nctx
    assert N.current() is N.DEFAULT
    assert N.current_path() == ""


def test_use_accepts_bare_ecfg_context_and_backend_override():
    with N.use(P8, backend="exact") as nctx:
        assert nctx.policy.default == P8
        assert nctx.backend == "exact"
    ctx = N.NumericsContext.from_ecfg(P16, backend="cuda")
    with N.use(ctx) as got:
        assert got is ctx
    with N.use(ctx, backend="lax_ref") as got:
        assert got.backend == "lax_ref" and got.policy == ctx.policy
    with pytest.raises(TypeError):
        with N.use("P16"):
            pass
    assert N.current() is N.DEFAULT


def test_exact_backend_ignores_approximation(rng):
    a, b = _t(rng, (16, 32)), _t(rng, (32, 8))
    with N.use(P8, backend="exact"):
        out = N.matmul(a, b)
    np.testing.assert_allclose(out.numpy(), (a @ b).numpy(), rtol=1e-6)


def test_lax_ref_matches_engine(rng):
    a, b = _t(rng, (24, 40)), _t(rng, (40, 12))
    with N.use(P16):
        out = N.matmul(a, b)
    np.testing.assert_array_equal(out.numpy(),
                                  euler_matmul(a, b, P16).numpy())


@pytest.mark.parametrize("backend", ["lax_ref", "cuda"])
def test_matmul_matches_reference_under_use(backend, rng):
    """``N.matmul`` under ``use(policy)`` against the reference's
    ``N.matmul`` under the same policy (its ``lax_ref``; the ``cuda`` route
    runs the kernels' plain versions on CPU tensors)."""
    a, b = (rng.normal(size=(16, 16)).astype(np.float32) for _ in range(2))
    with JN.use(JN.PrecisionPolicy.uniform(JE.from_variant(16, "L-21b"))):
        want = np.asarray(JN.matmul(jnp.asarray(a), jnp.asarray(b)))
    with N.use(N.PrecisionPolicy.uniform(P16), backend=backend):
        got = N.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


OPS = {"qk": (TE.euler_einsum_qk, [(2, 6, 16), (2, 9, 16)]),
       "pv": (TE.euler_einsum_pv, [(2, 6, 9), (2, 9, 16)]),
       "elementwise": (TE.ilm_elementwise, [(6, 16), (6, 16)])}


@pytest.mark.parametrize("op", sorted(OPS))
def test_free_ops_dispatch_the_engine(op, rng):
    """``N.qk``/``N.pv``/``N.elementwise`` under ``use`` on ``lax_ref``
    are the engine's functions, bit for bit (those are held against the
    reference in ``test_torch_oracles.py`` and ``test_torch_core.py``)."""
    fn, shapes = OPS[op]
    a, b = (_t(rng, s) for s in shapes)
    with N.use(P16):
        got = getattr(N, op)(a, b)
    np.testing.assert_array_equal(got.numpy(), fn(a, b, P16).numpy())


def test_use_is_thread_local(rng):
    """A second thread sees ``DEFAULT`` (exact) while the first is inside
    ``use``; its own ``use`` does not leak back."""
    a, b = _t(rng, (8, 16)), _t(rng, (16, 4))
    seen = {}
    entered, done = threading.Event(), threading.Event()

    def other():
        entered.wait()
        seen["ctx"] = N.current()
        seen["out"] = N.matmul(a, b)
        with N.use(P8):
            seen["inner"] = N.current().policy.default
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with N.use(P16) as mine:
        entered.set()
        done.wait(30)
        assert N.current() is mine
    t.join()
    assert seen["ctx"] is N.DEFAULT and seen["inner"] == P8
    np.testing.assert_allclose(seen["out"].numpy(), (a @ b).numpy(),
                               rtol=1e-6)
