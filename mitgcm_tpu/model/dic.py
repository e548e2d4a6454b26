"""pkg/dic: biotic carbon cycle (DIC, Alk, PO4, DOP, O2, FeT ptracers).

Reference: pkg/dic/dic_biotic_forcing.F (per-step driver, invoked from
GCHEM_FORCING_SEP after the ptracer advection-diffusion step —
GCHEM_SEPARATE_FORCING, forward_step.F:1105), carbon_chem.F
(CARBON_COEFFS dissociation constants + CALC_PCO2_APPROX one-iteration
pH/pCO2 follows/mick solver), dic_surfforcing.F (air-sea CO2 flux),
o2_surfforcing.F (O2 saturation + flux), alk_surfforcing.F,
bio_export.F + insol.F (light-and-nutrient-limited export production),
phos_flux.F (Martin-curve remineralisation), car_flux.F (carbonate
rain/dissolution), fe_chem.F (ligand partition + scavenging),
dic_surfforcing_init.F (10-iteration initial pH spin), dic_readparms.F
/ dic_init_fixed.F (defaults & fixed coefficients).

Compile flags mirrored from the verification decks' DIC_OPTIONS.h:
DIC_BIOTIC + ALLOW_O2 + ALLOW_FE; DIC_AD_SAFE replaces the min() in
the nutrient limitation by a tanh blend (bio_export.F:63-71) — we keep
the plain min for forward digit-matching and switch to the tanh form
under AD (both agree to machine precision away from the crossover).

Design: everything is elementwise per column — the whole package
fuses into the tracer step as vector ops; the only sequential piece is
the k-scan of light attenuation and the (nr x nr) sinking-flux
redistribution, both unrolled over the 15 levels.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from mitgcm_tpu.core.config import Config

# dic_init_fixed.F:39-61
SCA = (2073.1, -125.62, 3.6276, -0.043219)
SOX = (1638.0, -81.83, 1.483, -0.008004)
OA = (2.00907, 3.22014, 4.05010, 4.94457, -2.56847e-1, 3.88767)
OB = (-6.24523e-3, -7.37614e-3, -1.03410e-2, -8.17083e-3)
OC0 = -4.88682e-7
# insol.F:44-45
SOLAR, ALBEDO = 1360.0, 0.6


@dataclass
class DicParams:
    """dic_readparms.F defaults + data.dic overrides."""
    permil: float = 1.0 / 1024.5
    Pa2Atm: float = 1.01325e5
    zca: float = 3500.0
    DOPfraction: float = 0.67
    KDOPRemin: float = 1.0 / (6.0 * 30.0 * 86400.0)
    KRemin: float = 0.9
    O2crit: float = 4.0e-3
    R_OP: float = -170.0
    R_CP: float = 117.0
    R_NP: float = 16.0
    R_FeP: float = 0.000468
    parfrac: float = 0.4
    k0: float = 0.02
    lit0: float = 30.0
    KPO4: float = 5.0e-4
    KFE: float = 1.2e-7
    alpfe: float = 0.01
    freefemax: float = 3.0e-7
    KScav: float = 0.19 / (360.0 * 86400.0)
    ligand_stab: float = 1.0e8
    ligand_tot: float = 1.0e-6
    alphaUniform: float = 2.0e-3 / (360.0 * 86400.0)
    rainRatioUniform: float = 7.0e-2
    dic_pCO2: float = 278.0e-6
    DIC_windFile: str = ""
    DIC_atmospFile: str = ""
    DIC_iceFile: str = ""
    DIC_ironFile: str = ""
    DIC_silicaFile: str = ""
    DIC_forcingPeriod: float = 0.0
    DIC_forcingCycle: float = 0.0


def params_from_namelists(cfg: Config, nls: dict) -> DicParams:
    p = DicParams()
    g = {}
    for grp in ("ABIOTIC_PARMS", "BIOTIC_PARMS", "DIC_FORCING"):
        g.update({k.lower(): v for k, v in nls.get(grp, {}).items()})
    for attr in ("permil", "Pa2Atm", "zca", "DOPfraction", "KDOPRemin",
                 "KRemin", "O2crit", "R_OP", "R_CP", "R_NP", "R_FeP",
                 "parfrac", "k0", "lit0", "KPO4", "KFE", "alpfe",
                 "freefemax", "KScav", "ligand_stab", "ligand_tot",
                 "alphaUniform", "rainRatioUniform", "dic_pCO2"):
        if attr.lower() in g:
            setattr(p, attr, float(g[attr.lower()]))
    for attr in ("DIC_windFile", "DIC_atmospFile", "DIC_iceFile",
                 "DIC_ironFile", "DIC_silicaFile"):
        if attr.lower() in g:
            setattr(p, attr, str(g[attr.lower()]).strip())
    p.DIC_forcingPeriod = float(g.get("dic_forcingperiod",
                                      cfg.externForcingPeriod))
    p.DIC_forcingCycle = float(g.get("dic_forcingcycle",
                                     cfg.externForcingCycle))
    return p


def carbon_coeffs(t, s):
    """CARBON_COEFFS (carbon_chem.F:481-...): OCMIP2 dissociation
    constants; all arrays elementwise in (t [oC], s [psu])."""
    tk = 273.15 + t
    tk100 = tk / 100.0
    tk1002 = tk100 * tk100
    invtk = 1.0 / tk
    dlogtk = jnp.log(tk)
    is_ = 19.924 * s / (1000.0 - 1.005 * s)
    is2 = is_ * is_
    sqrtis = jnp.sqrt(is_)
    s2 = s * s
    sqrts = jnp.sqrt(s)
    s15 = s ** 1.5
    scl = s / 1.80655
    P1atm = 1.01325
    Rgas = 83.1451
    RT = Rgas * tk
    delta = 57.7 - 0.118 * tk
    B1 = -1636.75 + 12.0408 * tk - 0.0327957 * tk * tk
    B = B1 + 3.16528 * tk * tk * tk * 1.0e-5
    out = {}
    out["fugf"] = jnp.exp((B + 2.0 * delta) * P1atm / RT)
    out["ff"] = jnp.exp(-162.8301 + 218.2968 / tk100
                        + 90.9241 * jnp.log(tk100) - 1.47696 * tk1002
                        + s * (0.025695 - 0.025225 * tk100
                               + 0.0049867 * tk1002))
    out["ak0"] = jnp.exp(93.4517 / tk100 - 60.2409
                         + 23.3585 * jnp.log(tk100)
                         + s * (0.023517 - 0.023656 * tk100
                                + 0.0047036 * tk1002))
    out["ak1"] = 10.0 ** (-(3670.7 * invtk - 62.008 + 9.7944 * dlogtk
                            - 0.0118 * s + 0.000116 * s2))
    out["ak2"] = 10.0 ** (-(1394.7 * invtk + 4.777
                            - 0.0184 * s + 0.000118 * s2))
    out["akb"] = jnp.exp((-8966.90 - 2890.53 * sqrts - 77.942 * s
                          + 1.728 * s15 - 0.0996 * s2) * invtk
                         + (148.0248 + 137.1942 * sqrts + 1.62142 * s)
                         + (-24.4344 - 25.085 * sqrts - 0.2474 * s)
                         * dlogtk + 0.053105 * sqrts * tk)
    out["ak1p"] = jnp.exp(-4576.752 * invtk + 115.525
                          - 18.453 * dlogtk
                          + (-106.736 * invtk + 0.69171) * sqrts
                          + (-0.65643 * invtk - 0.01844) * s)
    out["ak2p"] = jnp.exp(-8814.715 * invtk + 172.0883
                          - 27.927 * dlogtk
                          + (-160.340 * invtk + 1.3566) * sqrts
                          + (0.37335 * invtk - 0.05778) * s)
    out["ak3p"] = jnp.exp(-3070.75 * invtk - 18.141
                          + (17.27039 * invtk + 2.81197) * sqrts
                          + (-44.99486 * invtk - 0.09984) * s)
    out["aksi"] = jnp.exp(-8904.2 * invtk + 117.385 - 19.334 * dlogtk
                          + (-458.79 * invtk + 3.5913) * sqrtis
                          + (188.74 * invtk - 1.5998) * is_
                          + (-12.1652 * invtk + 0.07871) * is2
                          + jnp.log(1.0 - 0.001005 * s))
    out["akw"] = jnp.exp(-13847.26 * invtk + 148.9652
                         - 23.6521 * dlogtk
                         + (118.67 * invtk - 5.977 + 1.0495 * dlogtk)
                         * sqrts - 0.01615 * s)
    out["aks"] = jnp.exp(
        -4276.1 * invtk + 141.328 - 23.093 * dlogtk
        + (-13856.0 * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
        + (35474.0 * invtk - 771.54 + 114.723 * dlogtk) * is_
        - 2698.0 * invtk * is_ ** 1.5 + 1776.0 * invtk * is2
        + jnp.log(1.0 - 0.001005 * s))
    out["akf"] = jnp.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis
                         + jnp.log(1.0 - 0.001005 * s)
                         + jnp.log(1.0 + (0.1400 / 96.062) * scl
                                   / out["aks"]))
    out["bt"] = 0.000232 * scl / 10.811
    out["st"] = 0.14 * scl / 96.062
    out["ft"] = 0.000067 * scl / 18.9984
    return out


def calc_pco2_approx(p: DicParams, t, s, dic, po4, sit, alk, co, pH):
    """CALC_PCO2_APPROX (carbon_chem.F:329-...): one Follows et al.
    iteration; returns (pH', pCO2)."""
    permil = p.permil
    pt = po4 * permil
    sit_ = sit * permil
    ta = alk * permil
    dicl = dic * permil
    hguess = 10.0 ** (-pH)
    bohg = co["bt"] * co["akb"] / (hguess + co["akb"])
    stuff = (hguess * hguess * hguess
             + co["ak1p"] * hguess * hguess
             + co["ak1p"] * co["ak2p"] * hguess
             + co["ak1p"] * co["ak2p"] * co["ak3p"])
    h3po4g = (pt * hguess * hguess * hguess) / stuff
    hpo4g = (pt * co["ak1p"] * co["ak2p"] * hguess) / stuff
    po4g = (pt * co["ak1p"] * co["ak2p"] * co["ak3p"]) / stuff
    siooh3g = sit_ * co["aksi"] / (co["aksi"] + hguess)
    cag = (ta - bohg - (co["akw"] / hguess) + hguess
           - hpo4g - 2.0 * po4g + h3po4g - siooh3g)
    gamm = dicl / cag
    stuff = ((1.0 - gamm) * (1.0 - gamm) * co["ak1"] * co["ak1"]
             - 4.0 * co["ak1"] * co["ak2"] * (1.0 - 2.0 * gamm))
    hnew = 0.5 * ((gamm - 1.0) * co["ak1"]
                  + jnp.sqrt(jnp.abs(stuff)))
    co2s = dicl / (1.0 + (co["ak1"] / hnew)
                   + (co["ak1"] * co["ak2"] / (hnew * hnew)))
    pH_new = -jnp.log10(hnew)
    fco2 = co2s / co["ak0"]
    pco2 = fco2 / co["fugf"]
    return pH_new, pco2


class Dic:
    """Per-step DIC chemistry + persistent surface pH."""

    TR_DIC, TR_ALK, TR_PO4, TR_DOP, TR_O2, TR_FE = range(6)

    def __init__(self, cfg: Config, grid, p: DicParams, fill2d,
                 dtype=jnp.float64, ad_safe=False):
        from mitgcm_tpu.io import mds
        self.cfg = cfg
        self.grid = grid
        self.p = p
        ks = cfg.ksurf0
        self.maskC0 = grid.maskC[ks]
        gx, gy = cfg.nx, cfg.nFaces * cfg.ny
        nrec = int(round(p.DIC_forcingCycle / p.DIC_forcingPeriod)) \
            if p.DIC_forcingCycle > 0.0 else 1
        self.nrec = nrec
        prec = ">f4" if cfg.readBinaryPrec == 32 else ">f8"

        def stack2d(fname, dflt):
            if not fname:
                return (dflt * jnp.ones_like(self.maskC0))[None]
            import os
            fp = cfg.find_file(fname)
            raw = np.asarray(mds.read_raw(fp, (-1, gy, gx), prec),
                             np.float64)
            if raw.shape[0] < nrec:      # single-record file
                raw = np.broadcast_to(raw[:1], (nrec,) + raw.shape[1:])
            return jnp.asarray(np.stack(
                [np.asarray(fill2d(raw[n]))
                 for n in range(min(nrec, raw.shape[0]))]), dtype)

        # dic_ini_forcing.F defaults (wind=5, AtmosP=1, silica=7.6838e-3,
        # fe input=1e-11*recip 2?? -> iron default 0), then file records
        self.wind = stack2d(p.DIC_windFile, 5.0)
        self.atmosp = stack2d(p.DIC_atmospFile, 1.0)
        self.fice = stack2d(p.DIC_iceFile, 0.0)
        self.silica = stack2d(p.DIC_silicaFile, 7.6838e-3)
        self.iron = stack2d(p.DIC_ironFile, 0.0)
        # AtmospCO2 (dic_int1=0): constant dic_pCO2 (dic_ini_atmos.F)
        self.atmos_pco2 = p.dic_pCO2
        # 2-D parameter fields (dic_init_varia.F:74-78) — control targets
        # for xx_alpha / xx_dic (dic_set_control.F)
        self.alpha = p.alphaUniform * jnp.ones_like(self.maskC0)
        self.rain_ratio = p.rainRatioUniform * jnp.ones_like(self.maskC0)
        # DIC_AD_SAFE (bio_export.F:128-134): tanh blend replacing the
        # min() in the nutrient limitation — compiled in the AD decks
        # (tutorial_dic_adjoffline code_ad/DIC_OPTIONS.h) so their
        # forward series uses it too
        self.ad_safe = ad_safe
        # interior (non-halo) indicator for the DIC_COST global sum —
        # per-face halo-aware (dic_cost.F sums i=1..sNx, j=1..sNy only)
        ny2, nx2 = cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx
        im = np.zeros((cfg.nFaces, ny2, nx2))
        im[:, cfg.oly:ny2 - cfg.oly, cfg.olx:nx2 - cfg.olx] = 1.0
        self.intmask = jnp.asarray(im.reshape(cfg.nFaces * ny2, nx2),
                                   dtype)

    # ------------------------------------------------------------------
    def _cyclic(self, myTime):
        p = self.p
        per, cyc = p.DIC_forcingPeriod, p.DIC_forcingCycle
        if self.nrec <= 1 or cyc <= 0.0:
            z = jnp.zeros((), jnp.int32)
            return z, z, 1.0, 0.0
        locTime = myTime - per * 0.5 + cyc * (
            2.0 - jnp.round(myTime / cyc))
        tmpTime = jnp.mod(locTime, cyc)
        rec0 = jnp.floor(tmpTime / per).astype(jnp.int32)
        rec1 = jnp.mod(rec0 + 1, self.nrec)
        aW = (tmpTime - per * rec0) / per
        return rec0, rec1, 1.0 - aW, aW

    def fields_at(self, myTime):
        rec0, rec1, bW, aW = self._cyclic(myTime)

        def interp(st):
            if st.shape[0] == 1:
                return st[0]
            return (bW * jnp.take(st, rec0, axis=0)
                    + aW * jnp.take(st, rec1, axis=0))

        return {k: interp(getattr(self, k))
                for k in ("wind", "atmosp", "fice", "silica", "iron")}

    # ------------------------------------------------------------------
    def init_ph(self, pTr, theta_ks, salt_ks, n_iter=10):
        """dic_surfforcing_init.F: 10 CALC_PCO2_APPROX iterations from
        pH=8. dic_ini_forcing.F reads RECORD 1 of each forcing file --
        except silicaSurf, which (when DIC_forcingCycle>0) is
        re-interpolated to startTime (dic_ini_forcing.F:174-200)."""
        f = {k: getattr(self, k)[0]
             for k in ("wind", "atmosp", "fice", "silica", "iron")}
        if self.nrec > 1:
            rec0, rec1, bW, aW = self._cyclic(self.cfg.startTime)
            f["silica"] = (bW * jnp.take(self.silica, rec0, axis=0)
                           + aW * jnp.take(self.silica, rec1, axis=0))
        co = carbon_coeffs(jnp.where(self.maskC0 != 0, theta_ks, 0.0),
                           jnp.where(self.maskC0 != 0, salt_ks, 0.0))
        pH = 8.0 * jnp.ones_like(theta_ks)
        m = self.maskC0
        for _ in range(n_iter):
            pH_n, _ = calc_pco2_approx(
                self.p, theta_ks, salt_ks,
                pTr[self.TR_DIC, self.cfg.ksurf0] * m,
                pTr[self.TR_PO4, self.cfg.ksurf0] * m,
                f["silica"] * m, pTr[self.TR_ALK, self.cfg.ksurf0] * m,
                co, pH)
            pH = jnp.where(m != 0.0, pH_n, pH)
        return pH

    # ------------------------------------------------------------------
    def forcing_sep(self, pTr, theta, salt, pH, myTime, alpha_anom=None):
        """DIC_BIOTIC_FORCING: fractional-step update of the 6 tracers;
        returns (pTr', pH', FluxCO2 [mol/m2/s]).

        alpha_anom: optional additive xx_alpha control anomaly
        (CTRL_MAP_GENARR2D on alpha, ctrl_map_ini_genarr.F:325)."""
        cfg = self.cfg
        grid = self.grid
        p = self.p
        dt = cfg.deltaTTracer
        ks = cfg.ksurf0
        m0 = self.maskC0
        mC = grid.maskC
        hFacC = grid.hFacC
        drF = grid.drF
        recip_drF = grid.recip_drF
        recip_hFac = grid.recip_hFacC
        f = self.fields_at(myTime)
        t_s = theta[ks]
        s_s = salt[ks]
        alpha2d = self.alpha if alpha_anom is None \
            else self.alpha + alpha_anom

        # --- DIC_SURFFORCING: CO2 flux + pH update -------------------
        co = carbon_coeffs(jnp.where(m0 != 0, t_s, 0.0),
                           jnp.where(m0 != 0, s_s, 0.0))
        pH_new, pco2 = calc_pco2_approx(
            p, t_s, s_s, pTr[self.TR_DIC, ks] * m0,
            pTr[self.TR_PO4, ks] * m0, f["silica"] * m0,
            pTr[self.TR_ALK, ks] * m0, co, pH)
        pH_new = jnp.where(m0 != 0.0, pH_new, pH)
        pco2 = jnp.where(m0 != 0.0, pco2, 0.0)
        pisvel = 0.337 * f["wind"] ** 2 / 3.6e5
        kwexch_pre = pisvel * (1.0 - f["fice"])
        schmidt = SCA[0] + t_s * (SCA[1] + t_s * (SCA[2] + t_s * SCA[3]))
        schmidt = jnp.maximum(1.0e-2, schmidt)
        pco2sat = f["atmosp"] * self.atmos_pco2
        kw = kwexch_pre / jnp.sqrt(schmidt / 660.0)
        fluxco2 = jnp.where(
            m0 != 0.0,
            kw * (co["ff"] * pco2sat - pco2 * co["fugf"] * co["ak0"]),
            0.0) / p.permil
        surc = recip_drF[ks] * recip_hFac[ks] * fluxco2

        # --- ALK_SURFFORCING (no OLD_VIRTUALFLUX) --------------------
        sura = jnp.zeros_like(surc)

        # --- O2_SURFFORCING ------------------------------------------
        schm_o2 = SOX[0] + t_s * (SOX[1] + t_s * (SOX[2] + t_s * SOX[3]))
        kw_o2 = kwexch_pre / jnp.sqrt(jnp.abs(schm_o2) / 660.0)
        aTT = 298.15 - t_s
        aTK = 273.15 + t_s
        aTS = jnp.log(jnp.where(m0 != 0, aTT / aTK, 1.0))
        oC = (OA[0] + aTS * (OA[1] + aTS * (OA[2] + aTS * (
            OA[3] + aTS * (OA[4] + aTS * OA[5]))))
            + s_s * (OB[0] + aTS * (OB[1] + aTS * (OB[2] + aTS * OB[3])))
            + OC0 * s_s * s_s)
        o2sat = jnp.exp(oC) / 22391.6 * 1.0e3
        fluxo2 = jnp.where(
            m0 != 0.0,
            kw_o2 * (f["atmosp"] * o2sat - pTr[self.TR_O2, ks]), 0.0)
        suro = fluxo2 * recip_drF[ks] * recip_hFac[ks]

        # --- FE_CHEM: ligand partition -> free iron ------------------
        def free_fe(fe):
            ls, lt = p.ligand_stab, p.ligand_tot
            lig = (-ls * fe + ls * lt - 1.0
                   + jnp.sqrt((ls * fe - ls * lt + 1.0) ** 2
                              + 4.0 * ls * lt)) / (2.0 * ls)
            fel = lt - lig
            return jnp.where((mC > 0.0) & (fe != 0.0), fe - fel, 0.0)

        freefe = free_fe(pTr[self.TR_FE])

        # --- BIO_EXPORT (light from INSOL, nutrient limitation) ------
        # GCHEM_FORCING_SEP runs AFTER the forward_step time bump
        # (forward_step.F:807,1108) so INSOL sees the end-of-step time,
        # while the wind/ice/silica records were interpolated at the
        # start-of-step time by GCHEM_FIELDS_LOAD -> DIC_FIELDS_LOAD
        # (load_fields_driver.F:183)
        sfac = self._insol(myTime + self.cfg.deltaTClock)
        lit = sfac * (1.0 - f["fice"])
        dzh = 0.5 * p.k0 * drF[:, None, None] * hFacC
        bioac = []
        for k in range(cfg.nr):
            atten = dzh[k] + (dzh[k - 1] if k > 0 else 0.0)
            lit = lit * jnp.exp(-atten)
            po4k = pTr[self.TR_PO4, k]
            fek = pTr[self.TR_FE, k]
            thx = po4k / (po4k + p.KPO4)
            thy = fek / (fek + p.KFE)
            if self.ad_safe:
                # DIC_AD_SAFE (bio_export.F:128-134): smooth min();
                # tanh arg clamped — XLA:CPU's vectorized tanh NaNs on
                # huge magnitudes (same guard as gmredi.py:151-158),
                # and tanh saturates identically in f64 beyond |x|=30
                thaux = jnp.tanh(jnp.clip((thx - thy) * 1.0e6,
                                          -30.0, 30.0))
                nutlimit = (0.5 * (1.0 - thaux) * thx
                            + 0.5 * (1.0 + thaux) * thy)
            else:
                nutlimit = jnp.minimum(thx, thy)
            bioac.append(alpha2d * lit / (lit + p.lit0)
                         * mC[k] * nutlimit)
        bioac = jnp.stack(bioac)

        # --- PHOS_FLUX + CAR_FLUX: sinking-flux redistribution -------
        one_m_dop = 1.0 - p.DOPfraction
        car_s = bioac * p.R_CP * self.rain_ratio * one_m_dop
        pflux, exportflux = self._sink(bioac * one_m_dop,
                                       lambda dl, zb: jnp.exp(
                                           -p.KRemin * jnp.log(dl / zb)))
        cflux, _ = self._sink(car_s, lambda dl, zb: jnp.exp(
            -(dl - zb) / p.zca))

        # --- tendencies (dic_biotic_forcing.F:180-226) ---------------
        rdop = mC * p.KDOPRemin * pTr[self.TR_DOP]
        gpo4 = -bioac + pflux + rdop
        car = cflux - car_s
        gdop = bioac * p.DOPfraction - rdop
        galk = 2.0 * car - p.R_NP * gpo4
        gdic = car + p.R_CP * gpo4
        go2 = jnp.where(pTr[self.TR_O2] > p.O2crit, p.R_OP * gpo4, 0.0)
        gfe = p.R_FeP * gpo4 - p.KScav * freefe
        galk = galk.at[ks].add(sura)
        gdic = gdic.at[ks].add(surc)
        go2 = go2.at[ks].add(suro)
        gfe = gfe.at[ks].add(p.alpfe * f["iron"]
                             * recip_drF[ks] * recip_hFac[ks])
        new = [pTr[self.TR_DIC] + gdic * dt,
               pTr[self.TR_ALK] + galk * dt,
               pTr[self.TR_PO4] + gpo4 * dt,
               pTr[self.TR_DOP] + gdop * dt,
               pTr[self.TR_O2] + go2 * dt,
               pTr[self.TR_FE] + gfe * dt]
        out = jnp.stack(new)
        if pTr.shape[0] > 6:
            out = jnp.concatenate([out, pTr[6:]], axis=0)
        return out, pH_new, fluxco2

    # ------------------------------------------------------------------
    def _insol(self, myTime):
        """insol.F: daily-mean surface PAR as a function of latitude and
        time of (360-day) year."""
        yC = self.grid.yC
        pi = np.pi
        dayfrac = jnp.mod(myTime, 360.0 * 86400.0) / (360.0 * 86400.0)
        yday = 2.0 * pi * dayfrac
        delta = (0.006918
                 - 0.399912 * jnp.cos(yday) + 0.070257 * jnp.sin(yday)
                 - 0.006758 * jnp.cos(2.0 * yday)
                 + 0.000907 * jnp.sin(2.0 * yday)
                 - 0.002697 * jnp.cos(3.0 * yday)
                 + 0.001480 * jnp.sin(3.0 * yday))
        lat = yC * (pi / 180.0)
        sun1 = jnp.clip(-jnp.tan(delta) * jnp.tan(lat), -0.999, 0.999)
        dayhrs = jnp.abs(jnp.arccos(sun1))
        cosz = jnp.maximum(
            jnp.sin(delta) * jnp.sin(lat)
            + jnp.cos(delta) * jnp.cos(lat) * jnp.sin(dayhrs) / dayhrs,
            5.0e-3)
        frac = dayhrs / pi
        fluxi = SOLAR * (1.0 - ALBEDO) * cosz * frac * self.p.parfrac
        return jnp.maximum(1.0e-5, fluxi)

    def _sink(self, src, remin_fac):
        """phos_flux.F / car_flux.F: downward particle flux with a
        remineralisation profile remin_fac(depth_bottom, zbase).

        src [nr,...]: local production rate; returns (flux_divergence
        added per cell, exportflux)."""
        cfg = self.cfg
        grid = self.grid
        nr = cfg.nr
        hFacC = grid.hFacC
        drF = grid.drF
        recip_drF = grid.recip_drF
        recip_hFac = grid.recip_hFacC
        mC = grid.maskC
        rF = grid.rF
        pflux = jnp.zeros_like(src)
        export = jnp.zeros_like(src)
        for k in range(nr):
            wet = hFacC[k] > 0.0
            below_dry = (hFacC[k + 1] == 0.0) if k < nr - 1 \
                else jnp.ones_like(wet, bool)
            local = wet & below_dry
            pflux = pflux.at[k].add(jnp.where(local, src[k], 0.0))
            bexp = jnp.where(wet & ~below_dry,
                             src[k] * drF[k] * hFacC[k], 0.0)
            zbase = -rF[k + 1]
            flux_u = bexp
            for ko in range(k + 1, nr - 1):
                kop1 = min(nr - 1, ko + 1)
                depth_l = -rF[ko] + drF[ko]
                rfac = remin_fac(depth_l, zbase)
                flux_l = bexp * rfac * mC[kop1]
                pflux = pflux.at[ko].add(
                    (flux_u - flux_l) * recip_drF[ko] * recip_hFac[ko])
                export = export.at[ko].add(flux_u)
                flux_l = jnp.where(bexp != 0.0, flux_l, 0.0)
                flux_u = flux_l
            ko = nr - 1
            if ko > k:
                pflux = pflux.at[ko].add(
                    flux_u * recip_drF[ko] * recip_hFac[ko])
                export = export.at[ko].add(flux_u)
        return pflux, export
