"""Nonlinear horizontal viscosities: Smagorinsky, Leith, grid/Reynolds
limiters, and the strain-tension dissipation form.

Reference: pkg/mom_common/mom_calc_visc.F (per-level viscAh/viscA4 at
vorticity (Z) and divergence (D) points), mom_init_fixed.F:84-126 (grid
length scales L2/L3/L4rdt), mom_calc_tension.F / mom_calc_strain.F,
mom_hdissip.F (strain-tension form), set_parms.F:125-149 (the
useVariableVisc / useHarmonicVisc / useBiharmonicVisc switches).

Design: everything is computed for all Nr levels at once as fused
elementwise stencils — the reference's per-(bi,bj,k) scratch arrays
become whole-domain 3-D ops that XLA fuses into the momentum step.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from mitgcm_tpu.core.config import Config
from mitgcm_tpu.core.grid import Grid
from mitgcm_tpu.ops.stencil import shift as sh


def use_variable_visc(cfg: Config) -> bool:
    """set_parms.F:125-132 useVariableVisc."""
    return cfg.momViscosity and (
        cfg.viscAhGrid != 0.0 or cfg.viscA4Grid != 0.0
        or cfg.viscC2smag != 0.0 or cfg.viscC4smag != 0.0
        or cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
        or cfg.viscC2LeithQG != 0.0
        or cfg.viscC4leith != 0.0 or cfg.viscC4leithD != 0.0)


def use_harmonic_visc(cfg: Config) -> bool:
    """set_parms.F:134-140 useHarmonicVisc."""
    return cfg.momViscosity and (
        cfg.viscAh != 0.0 or cfg.viscAhD != 0.0 or cfg.viscAhZ != 0.0
        or cfg.viscAhGrid != 0.0 or cfg.viscC2smag != 0.0
        or cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
        or cfg.viscC2LeithQG != 0.0)


def use_biharmonic_visc(cfg: Config) -> bool:
    """set_parms.F:141-146 useBiharmonicVisc."""
    return cfg.momViscosity and (
        cfg.viscA4 != 0.0 or cfg.viscA4D != 0.0 or cfg.viscA4Z != 0.0
        or cfg.viscA4Grid != 0.0 or cfg.viscC4smag != 0.0
        or cfg.viscC4leith != 0.0 or cfg.viscC4leithD != 0.0)


def length_scales(cfg: Config, grid: Grid):
    """mom_init_fixed.F:84-126: grid length scales at D (cell-center)
    and Z (corner) points.  Returns dict of 2-D arrays."""
    recip_dt = 1.0 / cfg.deltaTMom if cfg.deltaTMom != 0.0 else 1.0
    rdx2 = np.asarray(grid.recip_dxF) ** 2 + np.asarray(grid.recip_dyF) ** 2
    L2_D = np.asarray(grid.rA).copy()
    if not cfg.useAreaViscLength:
        ok = rdx2 != 0.0
        L2_D = np.where(ok, 2.0 / np.where(ok, rdx2, 1.0), L2_D)
    rdz2 = np.asarray(grid.recip_dxV) ** 2 + np.asarray(grid.recip_dyU) ** 2
    L2_Z = np.asarray(grid.rAz).copy()
    if not cfg.useAreaViscLength:
        ok = rdz2 != 0.0
        L2_Z = np.where(ok, 2.0 / np.where(ok, rdz2, 1.0), L2_Z)
    out = {}
    for tag, L2 in (("D", L2_D), ("Z", L2_Z)):
        out[f"L2_{tag}"] = jnp.asarray(L2)
        out[f"L3_{tag}"] = jnp.asarray(L2 ** 1.5)
        out[f"L4rdt_{tag}"] = jnp.asarray(0.03125 * recip_dt * L2 ** 2)
    out["recip_dt"] = recip_dt
    return out


def calc_tension(cfg: Config, grid: Grid, u, v):
    """mom_calc_tension.F: D_T = (d(dy*u)/dx - d(dx*v)/dy)/rA at C."""
    t = ((sh(grid.dyG * u, di=1) - grid.dyG * u)
         - (sh(grid.dxG * v, dj=1) - grid.dxG * v)) * grid.recip_rA
    if cfg.useOBCS:
        t = t * grid.maskInC
    return t


def calc_strain(cfg: Config, grid: Grid, u, v):
    """mom_calc_strain.F: D_S = (d(dy*v)/dx + d(dx*u)/dy)/rAz at Z."""
    return ((grid.dyC * v - sh(grid.dyC * v, di=-1))
            + (grid.dxC * u - sh(grid.dxC * u, dj=-1))) * grid.recip_rAz


def calc_visc(cfg: Config, grid: Grid, scales, hDiv, vort3, tension,
              strain, KE, hFacZ):
    """mom_calc_visc.F: per-level 2-D viscosities.

    All inputs [nr, ny, nx]; vort3/strain are the BC'd versions
    (sideMaskFac applied where hFacZ==0, mom_vecinv.F:288-295).
    Returns (viscAh_Z, viscAh_D, viscA4_Z, viscA4_D)."""
    pi = np.pi
    recip_dt = scales["recip_dt"]

    viscAhRe_max = (np.sqrt(2.0) / cfg.viscAhReMax
                    if (use_harmonic_visc(cfg) and cfg.viscAhReMax != 0.0)
                    else 0.0)
    viscA4Re_max = (0.125 * np.sqrt(2.0) / cfg.viscA4ReMax
                    if (use_biharmonic_visc(cfg)
                        and cfg.viscA4ReMax != 0.0) else 0.0)

    calcLeith = (cfg.viscC2leith != 0.0 or cfg.viscC2leithD != 0.0
                 or cfg.viscC4leith != 0.0 or cfg.viscC4leithD != 0.0
                 or cfg.viscC2LeithQG != 0.0)
    calcSmag = cfg.viscC2smag != 0.0 or cfg.viscC4smag != 0.0

    smag2fac = (cfg.viscC2smag / pi) ** 2 if calcSmag else 0.0
    smag4fac = 0.125 * (cfg.viscC4smag / pi) ** 2 if calcSmag else 0.0
    if calcLeith:
        if cfg.useFullLeith:
            leith2fac = (cfg.viscC2leith / pi) ** 6
            leithD2fac = (cfg.viscC2leithD / pi) ** 6
            leith4fac = 0.015625 * (cfg.viscC4leith / pi) ** 6
            leithD4fac = 0.015625 * (cfg.viscC4leithD / pi) ** 6
        else:
            leith2fac = (cfg.viscC2leith / pi) ** 3
            leithD2fac = (cfg.viscC2leithD / pi) ** 3
            leith4fac = 0.125 * (cfg.viscC4leith / pi) ** 3
            leithD4fac = 0.125 * (cfg.viscC4leithD / pi) ** 3
    else:
        leith2fac = leithD2fac = leith4fac = leithD4fac = 0.0

    z = jnp.zeros_like(hDiv)
    divDx = divDy = vrtDx = vrtDy = z
    if calcLeith:
        divDx = (hDiv - sh(hDiv, di=-1)) * grid.recip_dxC
        divDy = (hDiv - sh(hDiv, dj=-1)) * grid.recip_dyC
        vrtDx = (sh(vort3, di=1) - vort3) * grid.recip_dxG * grid.maskS
        vrtDy = (sh(vort3, dj=1) - vort3) * grid.recip_dyG * grid.maskW
        if cfg.useOBCS:
            vrtDx = vrtDx * grid.maskInS
            vrtDy = vrtDy * grid.maskInW

    def limits(base, Lth, Smg, Uscl, grid_visc, L2rdt_or_L4rdt,
               gmin, gmax, vmax):
        Alin = base + grid_visc * L2rdt_or_L4rdt + Lth + Smg
        vMin = jnp.maximum(gmin * L2rdt_or_L4rdt, Uscl)
        out = jnp.maximum(vMin, Alin)
        vMax = jnp.minimum(gmax * L2rdt_or_L4rdt, vmax)
        return jnp.minimum(vMax, out)

    # ---- D (divergence / cell-center) point --------------------------
    L2 = scales["L2_D"]
    L2rdt = 0.25 * recip_dt * L2
    L3 = scales["L3_D"]
    L4rdt = scales["L4rdt_D"]
    L5 = L2 * L3

    if viscAhRe_max > 0.0:
        UsclD = jnp.where(KE > 0.0, jnp.sqrt(jnp.maximum(KE, 0.0) * L2)
                          * viscAhRe_max, 0.0)
    else:
        UsclD = z
    if viscA4Re_max > 0.0:
        U4sclD = jnp.where(KE > 0.0, jnp.sqrt(jnp.maximum(KE, 0.0)) * L3
                           * viscA4Re_max, 0.0)
    else:
        U4sclD = z

    if cfg.useFullLeith and calcLeith:
        grdVrt = 0.25 * ((sh(vrtDx, dj=1) ** 2 + vrtDx ** 2)
                         + (sh(vrtDy, di=1) ** 2 + vrtDy ** 2))
        grdDiv = 0.25 * ((sh(divDx, di=1) ** 2 + divDx ** 2)
                         + (sh(divDy, dj=1) ** 2 + divDy ** 2))
        AhLthD = jnp.sqrt(leith2fac * grdVrt + leithD2fac * grdDiv) * L3
        A4LthD = jnp.sqrt(leith4fac * grdVrt + leithD4fac * grdDiv) * L5
    elif calcLeith:
        grdVrt = jnp.maximum(
            jnp.maximum(jnp.abs(sh(vrtDx, dj=1)), jnp.abs(vrtDx)),
            jnp.maximum(jnp.abs(sh(vrtDy, di=1)), jnp.abs(vrtDy)))
        grdDiv = jnp.maximum(
            jnp.maximum(jnp.abs(sh(divDx, di=1)), jnp.abs(divDx)),
            jnp.maximum(jnp.abs(sh(divDy, dj=1)), jnp.abs(divDy)))
        AhLthD = (leith2fac * grdVrt + leithD2fac * grdDiv) * L3
        A4LthD = (leith4fac * grdVrt + leithD4fac * grdDiv) * L5
    else:
        AhLthD = A4LthD = z

    if calcSmag:
        s = jnp.sqrt(tension ** 2
                     + 0.25 * (sh(strain, di=1) ** 2
                               + sh(strain, dj=1) ** 2
                               + strain ** 2
                               + sh(sh(strain, di=1), dj=1) ** 2))
        AhSmgD_base = L2 * s
        A4SmgD = smag4fac * L2 * AhSmgD_base
        AhSmgD = smag2fac * AhSmgD_base
    else:
        AhSmgD = A4SmgD = z

    viscAh_D = limits(cfg.viscAhD, AhLthD, AhSmgD, UsclD, cfg.viscAhGrid,
                      L2rdt, cfg.viscAhGridMin, cfg.viscAhGridMax,
                      cfg.viscAhMax)
    viscA4_D = limits(cfg.viscA4D, A4LthD, A4SmgD, U4sclD, cfg.viscA4Grid,
                      L4rdt, cfg.viscA4GridMin, cfg.viscA4GridMax,
                      cfg.viscA4Max)

    # ---- Z (vorticity / corner) point --------------------------------
    L2 = scales["L2_Z"]
    L2rdt = 0.25 * recip_dt * L2
    L3 = scales["L3_Z"]
    L4rdt = scales["L4rdt_Z"]
    L5 = L2 * L3

    if viscAhRe_max > 0.0 or viscA4Re_max > 0.0:
        keZpt = 0.25 * ((KE + sh(sh(KE, di=-1), dj=-1))
                        + (sh(KE, di=-1) + sh(KE, dj=-1)))
        pos = keZpt > 0.0
        UsclZ = jnp.where(pos, jnp.sqrt(jnp.maximum(keZpt, 0.0) * L2)
                          * viscAhRe_max, 0.0)
        U4sclZ = jnp.where(pos, jnp.sqrt(jnp.maximum(keZpt, 0.0)) * L3
                           * viscA4Re_max, 0.0)
    else:
        UsclZ = U4sclZ = z

    if cfg.useFullLeith and calcLeith:
        grdVrt = 0.25 * ((sh(vrtDx, di=-1) ** 2 + vrtDx ** 2)
                         + (sh(vrtDy, dj=-1) ** 2 + vrtDy ** 2))
        grdDiv = 0.25 * ((sh(divDx, dj=-1) ** 2 + divDx ** 2)
                         + (sh(divDy, di=-1) ** 2 + divDy ** 2))
        AhLthZ = jnp.sqrt(leith2fac * grdVrt + leithD2fac * grdDiv) * L3
        A4LthZ = jnp.sqrt(leith4fac * grdVrt + leithD4fac * grdDiv) * L5
    elif calcLeith:
        grdVrt = jnp.maximum(
            jnp.maximum(jnp.abs(sh(vrtDx, di=-1)), jnp.abs(vrtDx)),
            jnp.maximum(jnp.abs(sh(vrtDy, dj=-1)), jnp.abs(vrtDy)))
        grdDiv = jnp.maximum(
            jnp.maximum(jnp.abs(sh(divDx, dj=-1)), jnp.abs(divDx)),
            jnp.maximum(jnp.abs(sh(divDy, di=-1)), jnp.abs(divDy)))
        AhLthZ = (leith2fac * grdVrt + leithD2fac * grdDiv) * L3
        A4LthZ = (leith4fac * grdVrt + leithD4fac * grdDiv) * L5
    else:
        AhLthZ = A4LthZ = z

    if calcSmag:
        s = jnp.sqrt(strain ** 2
                     + 0.25 * (tension ** 2
                               + sh(tension, dj=-1) ** 2
                               + sh(tension, di=-1) ** 2
                               + sh(sh(tension, di=-1), dj=-1) ** 2))
        AhSmgZ_base = L2 * s
        A4SmgZ = smag4fac * L2 * AhSmgZ_base
        AhSmgZ = smag2fac * AhSmgZ_base
    else:
        AhSmgZ = A4SmgZ = z

    viscAh_Z = limits(cfg.viscAhZ, AhLthZ, AhSmgZ, UsclZ, cfg.viscAhGrid,
                      L2rdt, cfg.viscAhGridMin, cfg.viscAhGridMax,
                      cfg.viscAhMax)
    viscA4_Z = limits(cfg.viscA4Z, A4LthZ, A4SmgZ, U4sclZ, cfg.viscA4Grid,
                      L4rdt, cfg.viscA4GridMin, cfg.viscA4GridMax,
                      cfg.viscA4Max)

    return viscAh_Z, viscAh_D, viscA4_Z, viscA4_D


def hdissip_strain_tension(cfg: Config, grid: Grid, tension, strain,
                           viscAh_s, viscAh_t):
    """mom_hdissip.F harmonic strain-tension dissipation.

    viscAh_s = viscAh at Z (strain) points, viscAh_t = at C (tension)
    points — the (viscAh_Z, viscAh_D) pair at the mom_vecinv.F:424 call.
    Biharmonic is not allowed with strain-tension (mom_hdissip.F STOP).
    """
    ft = grid.dyF * grid.dyF * viscAh_t * tension
    fs = grid.dxV * grid.dxV * viscAh_s * strain
    uDiss = (grid.recip_dyG ** 2 * grid.recip_dxC
             * (ft - sh(ft, di=-1))
             + grid.recip_dxC ** 2 * grid.recip_dyG
             * (sh(fs, dj=1) - fs))
    fs2 = grid.dyU * grid.dyU * viscAh_s * strain
    ft2 = grid.dxF * grid.dxF * viscAh_t * tension
    vDiss = (grid.recip_dyC ** 2 * grid.recip_dxG
             * (sh(fs2, di=1) - fs2)
             - grid.recip_dxG ** 2 * grid.recip_dyC
             * (ft2 - sh(ft2, dj=-1)))
    return uDiss, vDiss
