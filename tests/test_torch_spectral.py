"""Spectral code of the port against the JAX package, on the same inputs.

Tolerances: rtol 1e-6 for the elementwise functions (float32 on both
sides; XLA may fuse a multiply-add where torch rounds twice, a few ulp),
with an atol of a few ulp where a value cancels towards 0; rtol 1e-5 for
sums over lanes or matrix rows (summation order differs).
Fitted reflectances within 1e-4: the float32 Levenberg-Marquardt solves
sum in different orders, and the fit stops at the same 50 iterations.
"""

import jax.numpy as jnp
import numpy as np
import torch

from corona13_tpu.spectral import cie as jcie
from corona13_tpu.spectral import colour as jcolour
from corona13_tpu.spectral import fresnel_data as jfres
from corona13_tpu.spectral import rgb2spec as jr2s
from corona13_tpu_torch.spectral import cie as tcie
from corona13_tpu_torch.spectral import colour as tcolour
from corona13_tpu_torch.spectral import fresnel_data as tfres
from corona13_tpu_torch.spectral import rgb2spec as tr2s

RTOL = 1e-6


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=atol)


def test_lambda_and_cmf():
    r = np.random.default_rng(0).uniform(0, 1, 5000).astype(np.float32)
    r[:3] = (0.0, 0.999999, 0.5)
    lj, pj = jcie.sample_lambda_hero(jnp.asarray(r), 4)
    lt, pt = tcie.sample_lambda_hero(torch.as_tensor(r), 4)
    _close(lj, lt)
    _close(pj, pt)
    # CMFs on the same wavelengths, including both ends and outside
    lam = np.concatenate([np.asarray(lj).ravel(),
                          [359.0, 360.0, 830.0, 831.0]]).astype(np.float32)
    _close(jcie.xyz_of_lambda(jnp.asarray(lam)),
           tcie.xyz_of_lambda(torch.as_tensor(lam)), atol=1e-7)
    p = np.random.default_rng(1).uniform(0, 3, (5000, 4)).astype(np.float32)
    _close(jcie.spectral_to_xyz(lj, jnp.asarray(p)),
           tcie.spectral_to_xyz(torch.as_tensor(np.array(lj)),
                                torch.as_tensor(p)), rtol=1e-5)


def test_eval_coeff_and_ior():
    g = np.random.default_rng(2)
    c = g.normal(size=(300, 3)).astype(np.float32) * [1e-4, 1e-2, 1.0]
    c = c.astype(np.float32)
    lam = g.uniform(360, 830, (300, 4)).astype(np.float32)
    # 0.5 + 0.5 x / sqrt(1 + x^2) cancels towards 0 for x << 0: one ulp
    # of rsqrt there is an absolute 6e-8, so atol covers two ulps of 0.5
    _close(jr2s.eval_coeff(jnp.asarray(c)[:, None, :], jnp.asarray(lam)),
           tr2s.eval_coeff(torch.as_tensor(c)[:, None, :],
                           torch.as_tensor(lam)), atol=1.2e-7)
    _close(jcie.eta_from_abbe(1.5, 40.0, jnp.asarray(lam)),
           tcie.eta_from_abbe(1.5, 40.0, torch.as_tensor(lam)))
    for name in ('gold', 'cu', 'nonexistent'):
        n7, k7 = tfres.get_conductor(name)
        jn7, jk7 = jfres.get_conductor(name)
        np.testing.assert_array_equal(n7, jn7)
        rows_n = np.tile(n7, (300, 1))
        rows_k = np.tile(k7, (300, 1))
        jn, jk = jfres.eval_nk(jnp.asarray(rows_n), jnp.asarray(rows_k),
                               jnp.asarray(lam))
        tn, tk = tfres.eval_nk(torch.as_tensor(rows_n), torch.as_tensor(rows_k),
                               torch.as_tensor(lam))
        _close(jn, tn)
        _close(jk, tk)


def test_fit_coeff_reflectance():
    g = np.random.default_rng(3)
    rgb = g.uniform(0, 1, (48, 3)).astype(np.float32)
    rgb[:5] = [(0, 0, 0), (1, 1, 1), (0.6, 0.1, 0.1), (0.1, 0.6, 0.1),
               (0.7, 0.7, 0.7)]
    cj = np.asarray(jr2s.fit_coeff(jnp.asarray(rgb)))
    ct = tr2s.fit_coeff(rgb).numpy()
    lam = np.linspace(360, 830, 95).astype(np.float32)
    sj = np.asarray(jr2s.eval_coeff(jnp.asarray(cj)[:, None, :],
                                    jnp.asarray(lam)))
    st = tr2s.eval_coeff(torch.as_tensor(ct)[:, None, :],
                         torch.as_tensor(lam)).numpy()
    assert np.abs(sj - st).max() < 1e-4
    # scaled fit: same multipliers, black stays black after scene._fit
    big = np.array([[40.0, 40.0, 40.0], [0.0, 0.0, 0.0], [2.0, 0.5, 0.1]],
                   np.float32)
    from corona13_tpu import scene as jscene
    from corona13_tpu_torch import scene as tscene
    (jc, jm), (tc, tm) = jscene._fit(big), tscene._fit(big)
    np.testing.assert_array_equal(jm, tm)
    assert tm[1] == 0.0


def test_colour_convert_and_gamma():
    x = np.random.default_rng(4).uniform(-0.1, 3, (1000, 3)).astype(np.float32)
    for src, dst in (('xyz', 'srgb'), ('ergb', 'xyz'), ('aces', 'adobergb')):
        _close(jcolour.convert(jnp.asarray(x), src, dst),
               tcolour.convert(torch.as_tensor(x), src, dst),
               rtol=1e-5, atol=1e-6)
    _close(jcolour.srgb_gamma(jnp.asarray(x)),
           tcolour.srgb_gamma(torch.as_tensor(x)), rtol=1e-5)


def test_blackbody_matches_jax():
    """The reference's Planck convention (no factor 2), rtol 1e-5; 0 at and
    below 0 K."""
    g = np.random.default_rng(3)
    temp = g.uniform(-500, 8000, (64, 1)).astype(np.float32)
    temp[:4] = 0.0
    lam = g.uniform(360, 830, (1, 16)).astype(np.float32)
    j = np.asarray(jcie.blackbody(jnp.asarray(temp), jnp.asarray(lam)))
    t = tcie.blackbody(torch.as_tensor(temp), torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert (t[:4] == 0).all() and t.max() > 1.0
