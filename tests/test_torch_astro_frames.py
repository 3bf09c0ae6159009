"""The port's ephemeris frames (`asset_asrl_torch.Astro.Extensions`:
EPPRFrame, NBodyFrame, KeplerianEphemeris) against the JAX package's: the
three tests of `tests/test_astro_frames.py` on the port, and the EPPR
frame's tables (`RTable`, `WTable`, built by automatic differentiation of
the ephemeris interpolants), the EPPR and NBody equations of motion over a
family of seeded rows (values, Jacobians, adjoint Hessians) within 1e-9 of
the JAX package (reference calls jitted), rows on the tables' first and
last knots among them."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
import asset_asrl_tpu.Astro.Extensions as JE
import asset_asrl_torch.Astro.Extensions as TE
from test_torch_interp import family_pair

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

c = tast.Astro.Constants
JD0, JDF = 2459000.5, 2459060.5


def eppr_of(E, ecc, N):
    return E.EPPRFrame.TwoBodyAnalytic("EARTH", c.MuEarth, "MOON", c.MuMoon,
                                       c.LD, JD0, JDF, ecc=ecc, N=N)


@pytest.fixture(scope="module")
def eppr():
    return eppr_of(TE, 0.0549, 800), eppr_of(JE, 0.0549, 800)


def nbody_of(E):
    mustar, lstar = c.MuSun, c.AU
    tstar = np.sqrt(lstar ** 3 / mustar)
    N = 400
    tf = (JDF - JD0) * 24 * 3600 / tstar
    sun = [np.array([0, 0, 0, 0, 0, 0, t]) for t in np.linspace(0, tf, N + 1)]
    frame = E.NBodyFrame("SUN", c.MuSun, lstar, JD0, JDF, P1Data=sun)
    jup = E.KeplerianEphemeris(1.0, [5.2, 0.048, 0.02, 0, 0, 0.5], 0, tf, N)
    frame.AddBodyTable("JUPITER", jup, c.MuJupiter)
    return frame, tf


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, np.abs(a).max())


def test_eppr_roundtrip(eppr):
    T = np.array([0.8, 0.1, 0.05, 0.1, -0.2, 0.02, 3.0])
    I = eppr[0].EPPR_to_NDInertial([T])[0]
    T2 = eppr[0].NDInertial_to_EPPR([I])[0]
    assert np.max(np.abs(T - T2)) < 1e-7
    assert rel(eppr[1].EPPR_to_NDInertial([T])[0], I) <= 1e-9


def test_eppr_cr3bp_limit():
    eppr0 = eppr_of(TE, 0.0, 400)
    W = eppr0.WTable.Interpolate(2.0)[:3]
    R = eppr0.RTable.Interpolate(2.0)
    assert np.allclose(W, [0, 0, 1], atol=1e-5)
    assert abs(R[0] - 1) < 1e-9 and abs(R[1]) < 1e-6
    Args = tast.VectorFunctions.Arguments
    args = Args(7)
    eom = eppr0.EPPREOMs(args.head3(), args.segment3(3), args[6])
    a6 = Args(6)
    cr = eppr0.CR3BPEOMs(a6.head3(), a6.tail3())
    x = np.array([0.5, 0.1, 0.02, 0.1, 0.3, -0.05, 2.0])
    assert np.max(np.abs(eom.compute(x) - cr.compute(x[:6]))) < 2e-4


def test_nbody_frame():
    frame, tf = nbody_of(TE)
    T = np.array([1.0, 0.2, 0.0, -0.1, 0.9, 0.01, tf / 2])
    I = frame.Frame_to_NDInertial([T])[0]
    T2 = frame.NDInertial_to_Frame([I])[0]
    assert np.max(np.abs(T - T2)) < 1e-10
    Args = tast.VectorFunctions.Arguments
    args = Args(7)
    eom = frame.NBodyEOMs(args.head3(), args.segment3(3), args[6],
                          Enable_P1_Acc=False)
    out = eom.compute(T)
    r = T[:3]
    twobody = -r / np.linalg.norm(r) ** 3
    assert np.max(np.abs(out[3:6] - twobody)) < 1e-3
    assert np.max(np.abs(out[3:6] - twobody)) > 0


def test_eppr_tables_and_eoms_match_jax(eppr):
    """The AD-built frame tables at seeded times, and the EPPR equations
    of motion (with J2 of both primaries and a registered third body)
    over 32 seeded rows, within 1e-9 of the JAX package."""
    tp, jp = eppr
    ts = np.random.default_rng(11).uniform(0.0, 13.0, 16)
    for name in ("RTable", "WTable", "WdotTable", "RotTable", "BCaccTable",
                 "GscaleTable"):
        a = np.array([getattr(jp, name).Interpolate(t) for t in ts])
        b = np.array([getattr(tp, name).Interpolate(t) for t in ts])
        assert rel(a, b) <= 1e-9, name
    eoms = []
    for fr, P in ((jp, jast), (tp, tast)):
        Args = P.VectorFunctions.Arguments
        fr.Add_P1_J2Effect(1.08e-3, 6.371e6)
        fr.Add_P2_J2Effect(2.03e-4, 1.737e6)
        if "SUN" not in fr.AltBodyNames:
            sun = P.Astro.Extensions.KeplerianEphemeris(
                1.0, [389.0, 0.0167, 0.09, 0, 0, 0.3], 0, 13.5, 200)
            fr.AddBodyTable("SUN", sun, c.MuSun)
        a = Args(7)
        eoms.append(fr.EPPREOMs(a.head3(), a.segment3(3), a[6],
                                Enable_J2=True))
    rng = np.random.default_rng(12)
    rows = np.concatenate([rng.normal(size=(32, 3)) * 0.3 + [0.6, 0, 0],
                           rng.normal(size=(32, 3)) * 0.2,
                           rng.uniform(0.0, 13.0, (32, 1))], axis=1)
    # rows on the tables' first and last knots, where both packages clamp
    # the time: the EOMs' time column there is JAX's (a `torch.clamp`
    # would double it)
    rows[:5, 6] = [0.0, 0.0, tp.RTable.TF, tp.RTable.TF, 13.5]
    ref, got = family_pair(*eoms, rows, rng.normal(size=(32, 6)))
    for a, b in zip(ref, got):
        assert rel(a, b) <= 1e-9
    F = tp.Transform_Func(tp)
    assert np.abs(F.compute(rows[0]) - rows[0]).max() < 1e-7


def test_nbody_eoms_match_jax():
    frames = [nbody_of(JE)[0], nbody_of(TE)[0]]
    eoms = []
    for fr, P in zip(frames, (jast, tast)):
        fr.Add_P1_J2Effect(2e-7, 6.957e8)
        a = P.VectorFunctions.Arguments(7)
        eoms.append(fr.NBodyEOMs(a.head3(), a.segment3(3), a[6],
                                 Enable_J2=True))
    rng = np.random.default_rng(13)
    rows = np.concatenate([rng.normal(size=(32, 3)) * 0.3 + [1.0, 0, 0],
                           rng.normal(size=(32, 3)) * 0.2 + [0, 1, 0],
                           rng.uniform(0.0, 1.0, (32, 1))], axis=1)
    # rows on the first and last knots of the P1 and Jupiter tables
    rows[:4, 6] = [0.0, 0.0, frames[1].P1Table.TF, frames[1].P1Table.TF]
    ref, got = family_pair(*eoms, rows, rng.normal(size=(32, 6)))
    for a, b in zip(ref, got):
        assert rel(a, b) <= 1e-9
    x = rows[3]
    assert rel(frames[0].NDInertial_to_Frame([x])[0],
               frames[1].NDInertial_to_Frame([x])[0]) <= 1e-12
