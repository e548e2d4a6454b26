"""Cubed-sphere (6-facet) topology and halo exchange.

The replacement for the reference's exch2 package
(pkg/exch2/W2_EXCH2_TOPOLOGY.h: per-tile neighbor lists with 2x2
index-permutation matrices encoding face-edge rotation;
w2_set_cs6_facets.F wires the 6-face cube). Here the topology is derived
directly from the `.mitgrid` corner coordinates: two face edges are
neighbors iff their corner points coincide on the sphere, which also
yields the orientation (reversed or not) — self-validating against the
grid files instead of hand-coded wiring.

Fields are stored per-face: [..., 6, n + 2*ol, n + 2*ol]. Halo exchange
is a precomputed flat gather (index + sign arrays), one `take` per field
— one gather kernel per fill; under shard_map the same maps drive the
exchange between face-holding devices.

Vector exchange follows the C-grid ownership rule of the cube: every
cube edge pairs an E/N side with a W/S side, so each shared-edge normal
velocity is owned by exactly one face's interior (the W/S side), and all
halo face values resolve to neighbor interiors (the reference encodes the
same property through exch2_uv bounds logic, pkg/exch2/exch2_get_uv_bounds.F).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

_RECORDS = ["xC", "yC", "dxF", "dyF", "rA", "xG", "yG", "dxV", "dyU",
            "rAz", "dxC", "dyC", "rAw", "rAs", "dxG", "dyG"]

# edge codes
N, S, E, W = 0, 1, 2, 3
_EDGES = [N, S, E, W]


def read_mitgrid(path: str, n: int) -> Dict[str, np.ndarray]:
    """Read one face file: 16 consecutive big-endian f64 records of
    (n+1)x(n+1) (model/src/ini_curvilinear_grid.F:292-345, order per
    SURVEY Appendix A; optional records 17-18 AngleCS/AngleSN)."""
    raw = np.fromfile(path, dtype=">f8")
    per = (n + 1) * (n + 1)
    nrec = raw.size // per
    if nrec < 16:
        raise ValueError(
            f"{path}: {raw.size} f64 values is fewer than 16 records of "
            f"({n + 1})x({n + 1}) — wrong face size n={n} for this file?")
    out = {}
    for irec in range(min(nrec, 18)):
        name = _RECORDS[irec] if irec < 16 else ("AngleCS", "AngleSN")[irec - 16]
        out[name] = raw[irec * per:(irec + 1) * per].reshape(n + 1, n + 1).astype(np.float64)
    return out


def _edge_corners(xg, yg, edge):
    """Corner coordinate sequence along an edge, as 3-D unit vectors.
    Along-direction: N/S edges follow increasing i, E/W increasing j."""
    if edge == N:
        lon, lat = xg[-1, :], yg[-1, :]
    elif edge == S:
        lon, lat = xg[0, :], yg[0, :]
    elif edge == E:
        lon, lat = xg[:, -1], yg[:, -1]
    else:
        lon, lat = xg[:, 0], yg[:, 0]
    lo = np.deg2rad(lon)
    la = np.deg2rad(lat)
    return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                     np.sin(la)], axis=-1)


class EdgeLink(NamedTuple):
    nbr: int       # neighbor face (0-based)
    nbr_edge: int  # which edge of the neighbor
    rev: bool      # along-edge order reversed


def build_topology(faces: List[Dict[str, np.ndarray]], n: int
                   ) -> Dict[Tuple[int, int], EdgeLink]:
    """Match all face-edge pairs by corner coordinates."""
    corners = {}
    for f, g in enumerate(faces):
        # xG/yG records are (n+1)x(n+1) with the full corner set
        for e in _EDGES:
            corners[(f, e)] = _edge_corners(g["xG"], g["yG"], e)
    topo: Dict[Tuple[int, int], EdgeLink] = {}
    tol = 1.0e-6
    for f in range(6):
        for e in _EDGES:
            a = corners[(f, e)]
            for g in range(6):
                if g == f:
                    continue
                for eg in _EDGES:
                    b = corners[(g, eg)]
                    if np.max(np.linalg.norm(a - b, axis=-1)) < tol:
                        topo[(f, e)] = EdgeLink(g, eg, False)
                    elif np.max(np.linalg.norm(a - b[::-1], axis=-1)) < tol:
                        topo[(f, e)] = EdgeLink(g, eg, True)
    missing = [k for f in range(6) for k in [(f, e) for e in _EDGES]
               if k not in topo]
    if missing:
        raise ValueError(f"cube topology incomplete; unmatched edges {missing}")
    return topo


def _cell_map(edge: int, link: EdgeLink, n: int):
    """Affine map from (depth d>=1, along a) beyond `edge` of a face to the
    neighbor's 0-based interior cell (j_g, i_g); also the image of the
    local x,y unit vectors in the neighbor frame.

    Returns (T, Mx, My): T(d, a) -> (j_g, i_g);
    Mx/My in {(+1,'x'),(-1,'x'),(+1,'y'),(-1,'y')} as (sign, axis)."""
    g, eg, rev = link

    def along(a):
        return (n - 1 - a) if rev else a

    if eg == N:
        def T(d, a):
            return (n - d, along(a))
        IN = (-1, "y")
        AL = (1, "x")
    elif eg == S:
        def T(d, a):
            return (d - 1, along(a))
        IN = (1, "y")
        AL = (1, "x")
    elif eg == E:
        def T(d, a):
            return (along(a), n - d)
        IN = (-1, "x")
        AL = (1, "y")
    else:
        def T(d, a):
            return (along(a), d - 1)
        IN = (1, "x")
        AL = (1, "y")
    sgn_al = -1 if rev else 1
    AL = (AL[0] * sgn_al, AL[1])

    # local OUT/ALONG for my edge
    if edge == N:
        OUT_is, AL_is = "y", "x"
        out_sign = 1
    elif edge == S:
        OUT_is, AL_is = "y", "x"
        out_sign = -1
    elif edge == E:
        OUT_is, AL_is = "x", "y"
        out_sign = 1
    else:
        OUT_is, AL_is = "x", "y"
        out_sign = -1
    # my OUT maps to neighbor IN; my ALONG maps to neighbor AL
    maps = {}
    maps[OUT_is] = (IN[0] * out_sign, IN[1])
    maps[AL_is] = AL
    Mx = maps["x"]
    My = maps["y"]
    return T, Mx, My


class CSExchange:
    """Precomputed gather maps for C/U/V/Z-point halo fills."""

    def __init__(self, faces: List[Dict[str, np.ndarray]], n: int, ol: int):
        self.n, self.ol = n, ol
        self.topo = build_topology(faces, n)
        self._build_scalar_map()
        self._build_scalar2_map()
        self._build_vector_map()
        self.build_z_map()

    # ---------------- scalar (cell-center) ----------------
    def _halo_cells(self):
        """Yield (face, edge, depth d>=1, along a, padded (jp, ip))."""
        n, ol = self.n, self.ol
        for f in range(6):
            for e in _EDGES:
                for d in range(1, ol + 1):
                    for a in range(n):
                        if e == N:
                            jp, ip = ol + n - 1 + d, ol + a
                        elif e == S:
                            jp, ip = ol - d, ol + a
                        elif e == E:
                            jp, ip = ol + a, ol + n - 1 + d
                        else:
                            jp, ip = ol + a, ol - d
                        yield f, e, d, a, jp, ip

    def _build_scalar_map(self):
        n, ol = self.n, self.ol
        nyp = nxp = n + 2 * ol
        size = 6 * nyp * nxp
        idx = np.arange(size).reshape(6, nyp, nxp).copy()
        valid = np.zeros((6, nyp, nxp), bool)
        valid[:, ol:ol + n, ol:ol + n] = True
        for f, e, d, a, jp, ip in self._halo_cells():
            link = self.topo[(f, e)]
            T, _, _ = _cell_map(e, link, n)
            jg, ig = T(d, a)
            idx[f, jp, ip] = (link.nbr * nyp + (jg + ol)) * nxp + (ig + ol)
            valid[f, jp, ip] = True
        self.sc_idx = jnp.asarray(idx.reshape(-1))
        self.sc_valid = jnp.asarray(valid.astype(np.float64))

    def fill_C(self, arr):
        """Fill halos of a cell-centered field [..., 6, nyp, nxp]."""
        flat = arr.reshape(arr.shape[:-3] + (-1,))
        out = jnp.take(flat, self.sc_idx, axis=-1)
        out = out.reshape(arr.shape)
        return out * self.sc_valid

    # ------- two-pass scalar exchange with corner regions (exch2) -------
    def _build_scalar2_map(self):
        """Second-pass gather (EXCH_UPDATE_CORNERS semantics): the ol x ol
        corner-diagonal blocks are written by the E/W neighbour entries
        extended along the edge (exch2_get_scal_bounds.F:58-91), sourcing
        the neighbour's post-pass-1 halo. exch2 processes neighbours in
        N,S,E,W order (w2_set_tile2tiles.F edge loop) so the x-side entry
        wins every corner block."""
        if hasattr(self, "sc2_idx"):
            return
        n, ol = self.n, self.ol
        nyp = nxp = n + 2 * ol
        idx = np.arange(6 * nyp * nxp).reshape(6, nyp, nxp).copy()
        ext = list(range(-ol, 0)) + list(range(n, n + ol))
        for f in range(6):
            for e in (E, W):
                link = self.topo[(f, e)]
                T, _, _ = _cell_map(e, link, n)
                for d in range(1, ol + 1):
                    ip = ol + n - 1 + d if e == E else ol - d
                    for a in ext:
                        jp = ol + a
                        jg, ig = T(d, a)
                        assert 0 <= jg + ol < nyp and 0 <= ig + ol < nxp
                        idx[f, jp, ip] = (link.nbr * nyp + (jg + ol)) \
                            * nxp + (ig + ol)
        # NumPy, not jnp: this builder can run lazily inside a jit
        # trace, where jnp.asarray returns a Tracer (caching it leaks)
        self.sc2_idx = idx.reshape(-1)

    def fill_T2(self, arr):
        """Scalar ('T ') exchange, two passes: edges then corner blocks
        from the x-neighbours' pass-1 halos (exch2_uv_cgrid_3d_rx.template
        :72-88 calls EXCH2_RX1_CUBE with IGNORE then UPDATE_CORNERS)."""
        self._build_scalar2_map()
        flat = arr.reshape(arr.shape[:-3] + (-1,))
        o1 = jnp.take(flat, self.sc_idx, axis=-1)
        o2 = jnp.take(o1, self.sc2_idx, axis=-1)
        return o2.reshape(arr.shape)

    def fill_UV_cgrid(self, u, v, with_sign: bool = True,
                      near_corner_fix: bool = True):
        """C-grid vector-pair exchange, the exact reference sequence
        (pkg/exch2/exch2_uv_cgrid_3d_rx.template):

        1. exchange each component as a scalar, two passes (fill_T2);
        2. per-face u<->v switch / sign / index shift on the rotated halo
           sections (odd faces: North then West; even faces: East then
           South);
        3. near-corner edge fixes;
        4. one extra valid u,v value next to each cube corner.
        """
        n, ol = self.n, self.ol
        neg = -1.0 if with_sign else 1.0
        uF = self.fill_T2(u)
        vF = self.fill_T2(v)
        rN = slice(ol + n, ol + n + ol)      # J = sNy+1 .. sNy+OLy
        cW = slice(0, ol)                    # I = 1-OLx .. 0
        cE = slice(ol + n, ol + n + ol)      # I = sNx+1 .. sNx+OLx
        rS = slice(0, ol)                    # J = 1-OLy .. 0
        us, vs = [], []
        for f in range(6):
            uf = uF[..., f, :, :]
            vf = vF[..., f, :, :]
            uo, vo = uf, vf
            odd = (f % 2 == 0)               # reference face f+1 is odd
            if odd:
                # North: u <- v revsign shift i+1<-i ; v <- u
                uo = uo.at[..., rN, 1:].set(vf[..., rN, :-1] * neg)
                vo = vo.at[..., rN, :].set(uf[..., rN, :])
                # West: u <- v ; v <- u revsign shift j+1<-j
                uo = uo.at[..., :, cW].set(vf[..., :, cW])
                vo = vo.at[..., 1:, cW].set(uf[..., :-1, cW] * neg)
            else:
                # East: u <- v ; v <- u revsign shift j+1<-j
                uo = uo.at[..., :, cE].set(vf[..., :, cE])
                vo = vo.at[..., 1:, cE].set(uf[..., :-1, cE] * neg)
                # South: u <- v revsign shift i+1<-i ; v <- u
                uo = uo.at[..., rS, 1:].set(vf[..., rS, :-1] * neg)
                vo = vo.at[..., rS, :].set(uf[..., rS, :])
            # -- step 3: fix edges near cube corners (in-place order);
            # the EXCH2_UV_3D ('Cg') flavor skips these fixes --
            for i in (range(1, ol + 1) if near_corner_fix else ()):
                if odd:   # SW: v(1-i,1) = u(1,1-i)*neg
                    vo = vo.at[..., ol, ol - i].set(
                        uo[..., ol - i, ol] * neg)
                else:     # SW: u(1,1-i) = v(1-i,1)*neg
                    uo = uo.at[..., ol - i, ol].set(
                        vo[..., ol, ol - i] * neg)
            for i in (range(1, ol + 1) if near_corner_fix else ()):
                if odd:   # SE: u(sNx+1,1-i) = v(sNx+i,1)
                    uo = uo.at[..., ol - i, ol + n].set(
                        vo[..., ol, ol + n - 1 + i])
                else:     # SE: v(sNx+i,1) = u(sNx+1,1-i)
                    vo = vo.at[..., ol, ol + n - 1 + i].set(
                        uo[..., ol - i, ol + n])
            for i in (range(1, ol + 1) if near_corner_fix else ()):
                if odd:   # NE: v(sNx+i,sNy+1) = u(sNx+1,sNy+i)*neg
                    vo = vo.at[..., ol + n, ol + n - 1 + i].set(
                        uo[..., ol + n - 1 + i, ol + n] * neg)
                else:     # NE: u(sNx+1,sNy+i) = v(sNx+i,sNy+1)*neg
                    uo = uo.at[..., ol + n - 1 + i, ol + n].set(
                        vo[..., ol + n, ol + n - 1 + i] * neg)
            for i in (range(1, ol + 1) if near_corner_fix else ()):
                if odd:   # NW: u(1,sNy+i) = v(1-i,sNy+1)
                    uo = uo.at[..., ol + n - 1 + i, ol].set(
                        vo[..., ol + n, ol - i])
                else:     # NW: v(1-i,sNy+1) = u(1,sNy+i)
                    vo = vo.at[..., ol + n, ol - i].set(
                        uo[..., ol + n - 1 + i, ol])
            # -- step 4: one extra valid u,v value next to each corner --
            # SW: u(0,0)=v(1,0); v(0,0)=u(0,1)
            uo = uo.at[..., ol - 1, ol - 1].set(vo[..., ol - 1, ol])
            vo = vo.at[..., ol - 1, ol - 1].set(uo[..., ol, ol - 1])
            # NW: u(0,sNy+1)=v(1,sNy+2)*neg; v(0,sNy+2)=u(0,sNy)*neg
            uo = uo.at[..., ol + n, ol - 1].set(
                vo[..., ol + n + 1, ol] * neg)
            vo = vo.at[..., ol + n + 1, ol - 1].set(
                uo[..., ol + n - 1, ol - 1] * neg)
            # SE: u(sNx+2,0)=v(sNx,0)*neg; v(sNx+1,0)=u(sNx+2,1)*neg
            uo = uo.at[..., ol - 1, ol + n + 1].set(
                vo[..., ol - 1, ol + n - 1] * neg)
            vo = vo.at[..., ol - 1, ol + n].set(
                uo[..., ol, ol + n + 1] * neg)
            # NE: u(sNx+2,sNy+1)=v(sNx,sNy+2); v(sNx+1,sNy+2)=u(sNx+2,sNy)
            uo = uo.at[..., ol + n, ol + n + 1].set(
                vo[..., ol + n + 1, ol + n - 1])
            # vPhi(sNx+1,sNy+2) = uPhi(sNx+2,sNy): j=sNy is row ol+n-1,
            # NOT the u(sNx+2,sNy+1) cell written by the line above
            vo = vo.at[..., ol + n + 1, ol + n].set(
                uo[..., ol + n - 1, ol + n + 1])
            us.append(uo)
            vs.append(vo)
        return jnp.stack(us, axis=-3), jnp.stack(vs, axis=-3)

    # ---------------- C-grid vector (u at W faces, v at S faces) -------
    def _build_vector_map(self):
        """u_halo/v_halo gathers from the stacked source [2, 6, nyp, nxp]
        (0=u, 1=v), with sign flips for rotated edges."""
        n, ol = self.n, self.ol
        nyp = nxp = n + 2 * ol
        fsz = nyp * nxp
        size = 2 * 6 * fsz

        def flat(comp, face, jg, ig):
            return ((comp * 6 + face) * nyp + jg) * nxp + ig

        u_idx = np.empty((6, nyp, nxp), np.int64)
        v_idx = np.empty((6, nyp, nxp), np.int64)
        u_sgn = np.zeros((6, nyp, nxp))
        v_sgn = np.zeros((6, nyp, nxp))
        # interior (and owned W/S edge columns) map to themselves
        for f in range(6):
            for jp in range(nyp):
                for ip in range(nxp):
                    u_idx[f, jp, ip] = flat(0, f, jp, ip)
                    v_idx[f, jp, ip] = flat(1, f, jp, ip)
        u_sgn[:, ol:ol + n, ol:ol + n] = 1.0
        v_sgn[:, ol:ol + n, ol:ol + n] = 1.0

        def face_value(f, cellA, cellB, axis):
            """Index+sign of the stored normal velocity for the face
            between adjacent cells A,B (0-based face-local cell indices,
            possibly outside [0,n)), separated along `axis` of face f.
            Chooses u (axis=x) or v (axis=y) at the higher-index cell."""
            (ja, ia), (jb, ib) = cellA, cellB
            if axis == "x":
                i_hi = max(ia, ib)
                j_hi = ja
                return flat(0, f, j_hi + self.ol, i_hi + self.ol)
            i_hi = ia
            j_hi = max(ja, jb)
            return flat(1, f, j_hi + self.ol, i_hi + self.ol)

        for f, e, d, a, jp, ip in self._halo_cells():
            link = self.topo[(f, e)]
            T, Mx, My = _cell_map(e, link, n)

            def map_cell(dd, aa):
                # extend T to depth 0 (our own edge row) via affinity
                if dd >= 1:
                    return T(dd, aa)
                j1, i1 = T(1, aa)
                j2, i2 = T(2, aa)
                return (2 * j1 - j2, 2 * i1 - i2)

            # --- u at this halo cell: face between (d,a) and its -x nbr
            if e in (E, W):
                # -x in face-local = depth direction +/-1
                dd0 = d - 1 if e == E else d + 1
                cA = map_cell(d, a)
                cB = map_cell(dd0, a)
            else:
                cA = map_cell(d, a)
                cB = map_cell(d, a - 1) if a - 1 >= 0 else None
                if cB is None:
                    # along-edge neighbor outside strip: extrapolate
                    j1, i1 = map_cell(d, 0)
                    j2, i2 = map_cell(d, 1)
                    cB = (2 * j1 - j2, 2 * i1 - i2)
            sgn, axis = Mx
            src = face_value(link.nbr, cA, cB, axis)
            u_idx[f, jp, ip] = src
            u_sgn[f, jp, ip] = sgn
            # for -x/-y mapped axes the "higher-index cell" convention
            # already picks the right stored face; the sign handles
            # direction reversal
            # --- v at this halo cell: face between (d,a) and its -y nbr
            if e in (N, S):
                dd0 = d - 1 if e == N else d + 1
                cA = map_cell(d, a)
                cB = map_cell(dd0, a)
            else:
                cA = map_cell(d, a)
                if a - 1 >= 0:
                    cB = map_cell(d, a - 1)
                else:
                    j1, i1 = map_cell(d, 0)
                    j2, i2 = map_cell(d, 1)
                    cB = (2 * j1 - j2, 2 * i1 - i2)
            sgn, axis = My
            src = face_value(link.nbr, cA, cB, axis)
            v_idx[f, jp, ip] = src
            v_sgn[f, jp, ip] = sgn

        self.u_idx = jnp.asarray(u_idx.reshape(-1))
        self.v_idx = jnp.asarray(v_idx.reshape(-1))
        self.u_sgn = jnp.asarray(u_sgn)
        self.v_sgn = jnp.asarray(v_sgn)

    def fill_UV(self, u, v, with_sign: bool = True):
        """Fill halos of a C-grid vector pair [..., 6, nyp, nxp]."""
        stacked = jnp.stack([u, v], axis=-4)
        flat = stacked.reshape(stacked.shape[:-4] + (-1,))
        un = jnp.take(flat, self.u_idx, axis=-1).reshape(u.shape)
        vn = jnp.take(flat, self.v_idx, axis=-1).reshape(v.shape)
        if with_sign:
            un = un * self.u_sgn
            vn = vn * self.v_sgn
        else:
            un = un * jnp.abs(self.u_sgn)
            vn = vn * jnp.abs(self.v_sgn)
        return un, vn


    # ---------------- exact 'Cg' exchange (EXCH2_RX2_CUBE) ----------------
    def _edge_affine(self, f, e):
        """Affine map (pi1,pi2,oi, pj1,pj2,oj): target Fortran indices
        (it,jt) of face f's halo beyond edge e -> source face indices
        (is,js) — the exch2_pij/oi/oj equivalent, fitted from _cell_map."""
        link = self.topo[(f, e)]
        T, _, _ = _cell_map(e, link, self.n)
        n = self.n

        def tgt(d, a):
            if e == N:
                return (a + 1, n + d)
            if e == S:
                return (a + 1, 1 - d)
            if e == E:
                return (n + d, a + 1)
            return (1 - d, a + 1)

        pts = [(1, 0), (1, 1), (2, 0)]
        A = []
        bi = []
        bj = []
        for d, a in pts:
            it, jt = tgt(d, a)
            jg, ig = T(d, a)
            A.append([it, jt, 1])
            bi.append(ig + 1)
            bj.append(jg + 1)
        sol_i = np.linalg.solve(np.array(A, float), np.array(bi, float))
        sol_j = np.linalg.solve(np.array(A, float), np.array(bj, float))
        pi1, pi2, oi = [int(round(x)) for x in sol_i]
        pj1, pj2, oj = [int(round(x)) for x in sol_j]
        return pi1, pi2, oi, pj1, pj2, oj, link.nbr

    @staticmethod
    def _cg_bounds(e, rev, n, eW, update, pij):
        """Literal port of pkg/exch2/exch2_get_uv_bounds.F for fCode='Cg'
        on a single-tile-per-face cube (all edges are facet edges)."""
        pi1, pi2, pj1, pj2 = pij
        if e == W:
            tIlo = tIhi = 0
            tJlo, tJhi = (n + 1, 0) if rev else (0, n + 1)
        elif e == E:
            tIlo = tIhi = n + 1
            tJlo, tJhi = (n + 1, 0) if rev else (0, n + 1)
        elif e == S:
            tJlo = tJhi = 0
            tIlo, tIhi = (n + 1, 0) if rev else (0, n + 1)
        else:
            tJlo = tJhi = n + 1
            tIlo, tIhi = (n + 1, 0) if rev else (0, n + 1)

        if tIlo == tIhi and tIlo == 0:       # west-edge overlap
            tIlo1, tIhi1, tis = 1 - eW, 0, 1
            tjs = 1 if tJlo <= tJhi else -1
            if update:
                tJlo1, tJhi1 = tJlo - tjs * (eW - 1), tJhi + tjs * (eW - 1)
            else:
                tJlo1, tJhi1 = tJlo + tjs, tJhi - tjs
        elif tIlo == tIhi:                   # east
            tIlo1, tIhi1, tis = tIlo, tIhi + eW - 1, 1
            tjs = 1 if tJlo <= tJhi else -1
            if update:
                tJlo1, tJhi1 = tJlo - tjs * (eW - 1), tJhi + tjs * (eW - 1)
            else:
                tJlo1, tJhi1 = tJlo + tjs, tJhi - tjs
        elif tJlo == tJhi and tJlo == 0:     # south
            tJlo1, tJhi1, tjs = 1 - eW, 0, 1
            tis = 1 if tIlo <= tIhi else -1
            if update:
                tIlo1, tIhi1 = tIlo - tis * (eW - 1), tIhi + tis * (eW - 1)
            else:
                tIlo1, tIhi1 = tIlo + tis, tIhi - tis
        else:                                # north
            tJlo1, tJhi1, tjs = tJlo, tJhi + eW - 1, 1
            tis = 1 if tIlo <= tIhi else -1
            if update:
                tIlo1, tIhi1 = tIlo - tis * (eW - 1), tIhi + tis * (eW - 1)
            else:
                tIlo1, tIhi1 = tIlo + tis, tIhi - tis

        tIlo2, tIhi2, tJlo2, tJhi2 = tIlo1, tIhi1, tJlo1, tJhi1
        doi1 = 1 if pi1 == -1 else 0
        doj1 = 1 if pj1 == -1 else 0
        doi2 = 1 if pi2 == -1 else 0
        doj2 = 1 if pj2 == -1 else 0
        if update:
            if pi1 == -1 or pj1 == -1:
                tIlo1 += 1
            if pi2 == -1 or pj2 == -1:
                tJlo2 += 1
            if tIlo == tIhi and tIlo > 1:       # east entry
                tJlo1 = tJlo + 1                # isSedge
                tJlo2 = tJlo + 1
                tJhi1 = tJhi - 1                # isNedge
                tJhi2 = tJhi
            if tJlo == tJhi and tJlo > 1:       # north entry
                tIlo1 = tIlo + 1                # isWedge
                tIlo2 = tIlo + 1
                tIhi1 = tIhi                    # isEedge
                tIhi2 = tIhi - 1
        else:
            if pi1 == -1 or pj1 == -1:
                tIlo1 += 1
                tIhi1 += 1
            if pi2 == -1 or pj2 == -1:
                tJlo2 += 1
                tJhi2 += 1
        return ((tIlo1, tIhi1, tJlo1, tJhi1, doi1, doj1),
                (tIlo2, tIhi2, tJlo2, tJhi2, doi2, doj2), tis, tjs)

    def _build_cg_maps(self):
        """Two-pass gather maps for the exact EXCH2_RX2_CUBE 'Cg'
        exchange (exch2_get_uv_bounds.F + exch2_put_rx2.template):
        the stagger-mode state exchange and shap_filt's exchange."""
        if hasattr(self, "cg_maps"):
            return
        n, ol = self.n, self.ol
        nyp = nxp = n + 2 * ol

        def flat(comp, face, r, c):
            return ((comp * 6 + face) * nyp + r) * nxp + c

        self.cg_maps = []
        for update in (False, True):
            u_idx = np.empty((6, nyp, nxp), np.int64)
            v_idx = np.empty((6, nyp, nxp), np.int64)
            for f in range(6):
                for r in range(nyp):
                    for c in range(nxp):
                        u_idx[f, r, c] = flat(0, f, r, c)
                        v_idx[f, r, c] = flat(1, f, r, c)
            u_sgn = np.ones((6, nyp, nxp))
            v_sgn = np.ones((6, nyp, nxp))
            for f in range(6):
                for e in (N, S, E, W):      # exch2 neighbour order
                    pi1, pi2, oi, pj1, pj2, oj, nbr = self._edge_affine(f, e)
                    # exch2 stores the per-tile bounds ascending in the
                    # target frame (reversal lives in the pij map)
                    b1, b2, tis, tjs = self._cg_bounds(
                        e, False, n, ol, update, (pi1, pi2, pj1, pj2))
                    for comp, (tIlo, tIhi, tJlo, tJhi, doi, doj) in (
                            (1, b1), (2, b2)):
                        sa_u = pi1 if comp == 1 else pi2
                        sa_v = pj1 if comp == 1 else pj2
                        for jtl in range(tJlo, tJhi + tjs, tjs):
                            for itl in range(tIlo, tIhi + tis, tis):
                                isl = pi1 * itl + pi2 * jtl + oi + doi
                                jsl = pj1 * itl + pj2 * jtl + oj + doj
                                tr, tc = jtl - 1 + ol, itl - 1 + ol
                                sr, sc = jsl - 1 + ol, isl - 1 + ol
                                assert 0 <= tr < nyp and 0 <= tc < nxp, (
                                    f, e, comp, itl, jtl)
                                assert 0 <= sr < nyp and 0 <= sc < nxp, (
                                    f, e, comp, itl, jtl, isl, jsl)
                                if sa_u != 0:
                                    src = flat(0, nbr, sr, sc)
                                    sgn = sa_u
                                else:
                                    src = flat(1, nbr, sr, sc)
                                    sgn = sa_v
                                if comp == 1:
                                    u_idx[f, tr, tc] = src
                                    u_sgn[f, tr, tc] = sgn
                                else:
                                    v_idx[f, tr, tc] = src
                                    v_sgn[f, tr, tc] = sgn
            self.cg_maps.append(
                (u_idx.reshape(-1), u_sgn, v_idx.reshape(-1), v_sgn))

    def fill_UV_cg(self, u, v, with_sign: bool = True):
        """Exact EXCH_UV_3D_RL for the cube: two RX2 'Cg' passes (ignore
        then update corners) + the one-extra-value corner copies
        (exch2_uv_3d_rx.template)."""
        self._build_cg_maps()
        n, ol = self.n, self.ol
        neg = -1.0 if with_sign else 1.0
        cur_u, cur_v = u, v
        for (ui, us, vi, vs) in self.cg_maps:
            st = jnp.stack([cur_u, cur_v], axis=-4)
            fl = st.reshape(st.shape[:-4] + (-1,))
            nu = jnp.take(fl, ui, axis=-1).reshape(u.shape)
            nv = jnp.take(fl, vi, axis=-1).reshape(v.shape)
            if with_sign:
                nu = nu * us
                nv = nv * vs
            cur_u, cur_v = nu, nv
        us_, vs_ = [], []
        for f in range(6):
            uo = cur_u[..., f, :, :]
            vo = cur_v[..., f, :, :]
            uo = uo.at[..., ol - 1, ol - 1].set(vo[..., ol - 1, ol])
            vo = vo.at[..., ol - 1, ol - 1].set(uo[..., ol, ol - 1])
            uo = uo.at[..., ol + n, ol - 1].set(
                neg * vo[..., ol + n + 1, ol])
            vo = vo.at[..., ol + n + 1, ol - 1].set(
                neg * uo[..., ol + n - 1, ol - 1])
            uo = uo.at[..., ol - 1, ol + n + 1].set(
                neg * vo[..., ol - 1, ol + n - 1])
            vo = vo.at[..., ol - 1, ol + n].set(
                neg * uo[..., ol, ol + n + 1])
            uo = uo.at[..., ol + n, ol + n + 1].set(
                vo[..., ol + n + 1, ol + n - 1])
            # vPhi(sNx+1,sNy+2) = uPhi(sNx+2,sNy): j=sNy is row ol+n-1,
            # NOT the u(sNx+2,sNy+1) cell written by the line above
            vo = vo.at[..., ol + n + 1, ol + n].set(
                uo[..., ol + n - 1, ol + n + 1])
            us_.append(uo)
            vs_.append(vo)
        return jnp.stack(us_, axis=-3), jnp.stack(vs_, axis=-3)

    # ---------------- corner (Z) points ----------------
    def build_z_map(self):
        """Gather map for corner-point fields (vorticity points, xG/yG,
        dxV/dyU/rAz, fCoriG): padded index (jp, ip) holds the corner at the
        cell's SW position; shared-edge corners are stored consistently on
        both faces, so halo corners map directly."""
        if hasattr(self, "z_idx"):
            return
        n, ol = self.n, self.ol
        nyp = nxp = n + 2 * ol
        idx = np.arange(6 * nyp * nxp).reshape(6, nyp, nxp).copy()
        valid = np.zeros((6, nyp, nxp))
        valid[:, ol:ol + n + 1, ol:ol + n + 1] = 1.0  # interior + NE edge row

        def corner_map(edge, link):
            g, eg, rev = link

            def along(a):       # corner index along edge, 0..n
                return (n - a) if rev else a

            if eg == N:
                def Tz(d, a):
                    return (n - d, along(a))
            elif eg == S:
                def Tz(d, a):
                    return (d, along(a))
            elif eg == E:
                def Tz(d, a):
                    return (along(a), n - d)
            else:
                def Tz(d, a):
                    return (along(a), d)
            return Tz

        for f in range(6):
            for e in _EDGES:
                link = self.topo[(f, e)]
                Tz = corner_map(e, link)
                for d in range(1, ol + 1):
                    for a in range(n + 1):
                        if e == N:
                            jp, ip = ol + n + d, ol + a
                        elif e == S:
                            jp, ip = ol - d, ol + a
                        elif e == E:
                            jp, ip = ol + a, ol + n + d
                        else:
                            jp, ip = ol + a, ol - d
                        if not (0 <= jp < nyp and 0 <= ip < nxp):
                            continue   # Z halo is one shallower on N/E
                        jg, ig = Tz(d, a)
                        if 0 <= jg <= n and 0 <= ig <= n:
                            idx[f, jp, ip] = (link.nbr * nyp + (jg + ol)) \
                                * nxp + (ig + ol)
                            valid[f, jp, ip] = 1.0
        self.z_idx = idx.reshape(-1)
        self.z_valid = valid

    def fill_Z(self, arr):
        self.build_z_map()
        flat = arr.reshape(arr.shape[:-3] + (-1,))
        out = jnp.take(flat, self.z_idx, axis=-1).reshape(arr.shape)
        return out * self.z_valid


# ----------------------------------------------------------------------
# stacked-face layout helpers: model fields are [..., 6*nyp, nxp] so the
# generic stencil kernels run unchanged (face = j-blocks, each with its
# own halo ring); the exchange reshapes to [..., 6, nyp, nxp]
# ----------------------------------------------------------------------

def _to_faces(a, nyp):
    return a.reshape(a.shape[:-2] + (6, nyp, a.shape[-1]))


def _from_faces(a):
    return a.reshape(a.shape[:-3] + (a.shape[-3] * a.shape[-2], a.shape[-1]))


class CSFill:
    """fill/fill_uv hooks for the stacked-face layout."""

    def __init__(self, ex: CSExchange):
        self.ex = ex
        self.nyp = ex.n + 2 * ex.ol

    def fill(self, a):
        # two-pass scalar exchange: edge halos then the corner-diagonal
        # blocks (EXCH2 UPDATE_CORNERS) — fill_C alone leaves zeros in
        # the OLxOL corner blocks, which the reference never has
        return _from_faces(self.ex.fill_T2(_to_faces(a, self.nyp)))

    def fill_uv(self, u, v, with_sign=True):
        uf, vf = self.ex.fill_UV_cgrid(_to_faces(u, self.nyp),
                                       _to_faces(v, self.nyp), with_sign)
        return _from_faces(uf), _from_faces(vf)

    def fill_uv_cg(self, u, v, with_sign=True):
        """EXCH_UV_3D_RL flavor: the exact two-pass RX2 'Cg' gather
        (stagger-mode state exchange + shap_filt exchange)."""
        uf, vf = self.ex.fill_UV_cg(_to_faces(u, self.nyp),
                                    _to_faces(v, self.nyp), with_sign)
        return _from_faces(uf), _from_faces(vf)

    def fill_z(self, a):
        return _from_faces(self.ex.fill_Z(_to_faces(a, self.nyp)))


def fill_cs_corner_uv(u, v, n: int, ol: int, with_sign: bool = False):
    """Fill the cube-corner halo blocks of a C-grid vector pair in the
    stacked-face layout [..., 6*nyp, nxp]
    (eesupp/src/fill_cs_corner_uv_rl.F, all four corners).

    Pure gather: corner cells are written from the adjacent halo strips,
    never read, so there are no in-place hazards."""
    neg = -1.0 if with_sign else 1.0
    nyp = n + 2 * ol
    for f in range(6):
        b = f * nyp
        for j in range(1, ol + 1):
            for i in range(1, ol + 1):
                # SW: u(1-i,1-j) = neg*v(1-j,1+i); v(1-i,1-j) = neg*u(1+j,1-i)
                u = u.at[..., b + ol - j, ol - i].set(
                    neg * v[..., b + ol + i, ol - j])
                v = v.at[..., b + ol - j, ol - i].set(
                    neg * u[..., b + ol - i, ol + j])
                # SE: u(sNx+i,1-j) = v(sNx+j,i) [i>=2];
                #     v(sNx+i,1-j) = u(sNx+1-j,1-i)
                if i >= 2:
                    u = u.at[..., b + ol - j, ol + n - 1 + i].set(
                        v[..., b + ol + i - 1, ol + n - 1 + j])
                v = v.at[..., b + ol - j, ol + n - 1 + i].set(
                    u[..., b + ol - i, ol + n - j])
                # NW: u(1-i,sNy+j) = v(1-j,sNy+1-i);
                #     v(1-i,sNy+j) = u(j,sNy+i) [j>=2]
                u = u.at[..., b + ol + n - 1 + j, ol - i].set(
                    v[..., b + ol + n - i, ol - j])
                if j >= 2:
                    v = v.at[..., b + ol + n - 1 + j, ol - i].set(
                        u[..., b + ol + n - 1 + i, ol + j - 1])
                # NE: u(sNx+i,sNy+j) = neg*v(sNx+j,sNy+2-i) [i>=2];
                #     v(sNx+i,sNy+j) = neg*u(sNx+2-j,sNy+i) [j>=2]
                if i >= 2:
                    u = u.at[..., b + ol + n - 1 + j, ol + n - 1 + i].set(
                        neg * v[..., b + ol + n + 1 - i, ol + n - 1 + j])
                if j >= 2:
                    v = v.at[..., b + ol + n - 1 + j, ol + n - 1 + i].set(
                        neg * u[..., b + ol + n - 1 + i, ol + n + 1 - j])
    return u, v


def fill_cs_corner(a, fill4dir: int, n: int, ol: int,
                   with_sign: bool = False):
    """Overwrite the ol x ol cube-corner halo blocks of a stacked-face
    field [..., 6*nyp, nxp] so that a subsequent derivative in one
    direction sees consistent values (eesupp/src/fill_cs_corner_tr_rl.F).

    fill4dir=1: reflect the W/E halo strips into the corners (use before
    an x-derivative); fill4dir=2: reflect the S/N halo strips (before a
    y-derivative); fill4dir=0: zero the corners.
    """
    neg = -1.0 if with_sign else 1.0
    nyp = n + 2 * ol
    for f in range(6):
        b = f * nyp
        for i in range(1, ol + 1):
            for j in range(1, ol + 1):
                if fill4dir == 0:
                    a = a.at[..., b + ol - j, ol - i].set(0.0)
                    a = a.at[..., b + ol - j, ol + n - 1 + i].set(0.0)
                    a = a.at[..., b + ol + n - 1 + j, ol - i].set(0.0)
                    a = a.at[..., b + ol + n - 1 + j,
                             ol + n - 1 + i].set(0.0)
                elif fill4dir == 1:
                    # SW: tr(1-i,1-j) = tr(1-j, i)
                    a = a.at[..., b + ol - j, ol - i].set(
                        neg * a[..., b + ol + i - 1, ol - j])
                    # SE: tr(sNx+i,1-j) = tr(sNx+j, i)
                    a = a.at[..., b + ol - j, ol + n - 1 + i].set(
                        neg * a[..., b + ol + i - 1, ol + n - 1 + j])
                    # NW: tr(1-i,sNy+j) = tr(1-j, sNy+1-i)
                    a = a.at[..., b + ol + n - 1 + j, ol - i].set(
                        neg * a[..., b + ol + n - i, ol - j])
                    # NE: tr(sNx+i,sNy+j) = tr(sNx+j, sNy+1-i)
                    a = a.at[..., b + ol + n - 1 + j, ol + n - 1 + i].set(
                        neg * a[..., b + ol + n - i, ol + n - 1 + j])
                elif fill4dir == 2:
                    # SW: tr(1-i,1-j) = tr(j, 1-i)
                    a = a.at[..., b + ol - j, ol - i].set(
                        neg * a[..., b + ol - i, ol + j - 1])
                    # SE: tr(sNx+i,1-j) = tr(sNx+1-j, 1-i)
                    a = a.at[..., b + ol - j, ol + n - 1 + i].set(
                        neg * a[..., b + ol - i, ol + n - j])
                    # NW: tr(1-i,sNy+j) = tr(j, sNy+i)
                    a = a.at[..., b + ol + n - 1 + j, ol - i].set(
                        neg * a[..., b + ol + n - 1 + i, ol + j - 1])
                    # NE: tr(sNx+i,sNy+j) = tr(sNx+1-j, sNy+i)
                    a = a.at[..., b + ol + n - 1 + j, ol + n - 1 + i].set(
                        neg * a[..., b + ol + n - 1 + i, ol + n - j])
                else:
                    raise ValueError(f"fill4dir={fill4dir}")
    return a
