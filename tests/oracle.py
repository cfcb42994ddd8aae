"""Scalar NumPy oracle emulating the Taichi reference's semantics.

Taichi is not installed in this environment, so golden fields cannot be
generated from the actual reference. This oracle re-implements the
reference's per-cell kernel semantics (``/root/reference/fs/*.py``) with
explicit scalar loops and explicit double buffers, independently from the
vectorized JAX implementation — catching any error in the full-array
re-formulation (shift directions, mask gathers, buffer staleness,
sweep ordering, NaN policy).

Where the reference's behavior is nondeterministic (parallel scatter
races) or undefined (out-of-bounds reads), this oracle implements the
*documented decisions* from ``docs/PARITY.md``, which the JAX build also
follows: gather-from-pre-kernel-values for BC kernels, clamp-to-edge for
the CIP kernels' direct neighbor reads.

Everything is float32; all loops are straight Python (slow — use small
grids).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def clamp_idx(n: int, i: int) -> int:
    return 0 if i < 0 else (n - 1 if i >= n else i)


def sample(f: np.ndarray, i: int, j: int):
    return f[clamp_idx(f.shape[0], i), clamp_idx(f.shape[1], j)]


def sgn(x) -> float:
    return F(-1.0) if x < 0.0 else F(1.0)


def fdiff_x(f, i, j, dx):
    return (sample(f, i + 1, j) - sample(f, i, j)) / F(dx)


def fdiff_y(f, i, j, dx):
    return (sample(f, i, j + 1) - sample(f, i, j)) / F(dx)


def bdiff_x(f, i, j, dx):
    return (sample(f, i, j) - sample(f, i - 1, j)) / F(dx)


def bdiff_y(f, i, j, dx):
    return (sample(f, i, j) - sample(f, i, j - 1)) / F(dx)


def diff_x(f, i, j, dx):
    return F(0.5) * (sample(f, i + 1, j) - sample(f, i - 1, j)) / F(dx)


def diff_y(f, i, j, dx):
    return F(0.5) * (sample(f, i, j + 1) - sample(f, i, j - 1)) / F(dx)


def diff2_x(f, i, j, dx):
    return (sample(f, i + 1, j) - F(2.0) * sample(f, i, j) + sample(f, i - 1, j)) / F(dx) ** 2


def diff2_y(f, i, j, dx):
    return (sample(f, i, j + 1) - F(2.0) * sample(f, i, j) + sample(f, i, j - 1)) / F(dx) ** 2


def advect_upwind(vc, phi, i, j, dx):
    k = i if vc[i, j, 0] < 0.0 else i - 1
    a = vc[i, j, 0] * fdiff_x(phi, k, j, dx)
    k = j if vc[i, j, 1] < 0.0 else j - 1
    b = vc[i, j, 1] * fdiff_y(phi, i, k, dx)
    return a + b


def advect_kk(vc, phi, i, j, dx):
    coef_neg = np.array([-2, 10, -9, 2, -1], dtype=F)
    coef_pos = -coef_neg[::-1]
    sx = [sample(phi, i + 2, j), sample(phi, i + 1, j), sample(phi, i, j),
          sample(phi, i - 1, j), sample(phi, i - 2, j)]
    cx = coef_neg if vc[i, j, 0] < 0 else coef_pos
    a = sum(c * s for c, s in zip(cx, sx)) / (F(6) * F(dx))
    sy = [sample(phi, i, j + 2), sample(phi, i, j + 1), sample(phi, i, j),
          sample(phi, i, j - 1), sample(phi, i, j - 2)]
    cy = coef_neg if vc[i, j, 1] < 0 else coef_pos
    b = sum(c * s for c, s in zip(cy, sy)) / (F(6) * F(dx))
    return vc[i, j, 0] * a + vc[i, j, 1] * b


def advect_central(vc, phi, i, j, dx):
    return vc[i, j, 0] * diff_x(phi, i, j, dx) + vc[i, j, 1] * diff_y(phi, i, j, dx)


ADVECT = {"upwind": advect_upwind, "kk": advect_kk, "central": advect_central}


class Buf:
    """Double buffer (``fs/double_buffer.py``)."""

    def __init__(self, shape):
        self.cur = np.zeros(shape, dtype=F)
        self.nxt = np.zeros(shape, dtype=F)

    def swap(self):
        self.cur, self.nxt = self.nxt, self.cur


class Oracle:
    """Reference-semantics emulator. `bc`, `mask`, `dye` are the raw scene
    arrays in reference layout ((X,Y,2), (X,Y) uint8, (X,Y,3))."""

    def __init__(self, bc, mask, bc_dye, *, dt, dx, re, scheme="upwind",
                 vor_eps=None, enable_dye=False, omega=1.3, n_iter=2,
                 pressure_solver="sor", velocity_limit=10.0):
        self.bc_const = bc.astype(F)
        self.mask = mask
        self.bc_dye = bc_dye.astype(F)
        self.dt, self.dx, self.re = F(dt), F(dx), F(re)
        self.scheme = scheme
        self.vor_eps = None if vor_eps is None else F(vor_eps)
        self.enable_dye = enable_dye
        self.omega, self.n_iter = F(omega), n_iter
        self.pressure_solver = pressure_solver
        self.vlimit = F(velocity_limit)

        shp = mask.shape
        self.v = Buf(shp + (2,))
        self.p = Buf(shp)
        self.vorticity = np.zeros(shp, dtype=F)
        self.vorticity_abs = np.zeros(shp, dtype=F)
        if scheme == "cip":
            self.vx = Buf(shp + (2,))
            self.vy = Buf(shp + (2,))
        if enable_dye:
            self.dye = Buf(shp + (3,))
            if scheme == "cip":
                self.dyex = Buf(shp + (3,))
                self.dyey = Buf(shp + (3,))

    # ---- BC kernels (fs/boundary_condition.py) ---------------------------
    def set_velocity_bc(self, vc):
        m = self.mask
        X, Y = m.shape
        snap = vc.copy()
        # Ghost mirror writes (scatter from interior wall triggers). Each
        # trigger selects ONE pattern via the reference's elif chain; when
        # two triggers target the same ghost cell (sub-2px walls — the
        # reference is racy there) we apply writes in pattern order 1→4 so
        # the documented priority (4 > 3 > 2 > 1, docs/PARITY.md §2) wins.
        writes = {1: [], 2: [], 3: [], 4: []}
        for i in range(1, X - 1):
            for j in range(1, Y - 1):
                if m[i, j] != 1:
                    continue
                if m[i - 1, j] == 0 and m[i, j - 1] == 1 and m[i, j + 1] == 1:
                    writes[1].append(((i + 1, j), -sample(snap, i - 1, j)))
                elif m[i + 1, j] == 0 and m[i, j - 1] == 1 and m[i, j + 1] == 1:
                    writes[2].append(((i - 1, j), -sample(snap, i + 1, j)))
                elif m[i, j - 1] == 0 and m[i - 1, j] == 1 and m[i + 1, j] == 1:
                    writes[3].append(((i, j + 1), -sample(snap, i, j - 1)))
                elif m[i, j + 1] == 0 and m[i - 1, j] == 1 and m[i + 1, j] == 1:
                    writes[4].append(((i, j - 1), -sample(snap, i, j + 1)))
        for pattern in (1, 2, 3, 4):
            for (ti, tj), val in writes[pattern]:
                vc[ti, tj] = val
        for i in range(X):
            for j in range(Y):
                if m[i, j] == 2:
                    vc[i, j] = self.bc_const[i, j]
                elif m[i, j] == 3:
                    vc[i, j, 0] = np.fmax(sample(snap, i - 1, j)[0], F(0.05))

    def set_pressure_bc(self, pc):
        m = self.mask
        X, Y = m.shape
        snap = pc.copy()

        def sm(i, j):  # clamped mask read (see docs/PARITY.md edge analysis)
            return m[clamp_idx(X, i), clamp_idx(Y, j)]

        for i in range(X):
            for j in range(Y):
                if m[i, j] == 1:
                    if sm(i - 1, j) == 0 and sm(i, j - 1) == 1 and sm(i, j + 1) == 1:
                        pc[i, j] = sample(snap, i - 1, j)
                    elif sm(i + 1, j) == 0 and sm(i, j - 1) == 1 and sm(i, j + 1) == 1:
                        pc[i, j] = sample(snap, i + 1, j)
                    elif sm(i, j - 1) == 0 and sm(i - 1, j) == 1 and sm(i + 1, j) == 1:
                        pc[i, j] = sample(snap, i, j - 1)
                    elif sm(i, j + 1) == 0 and sm(i - 1, j) == 1 and sm(i + 1, j) == 1:
                        pc[i, j] = sample(snap, i, j + 1)
                    elif sm(i - 1, j) == 0 and sm(i, j + 1) == 0:
                        pc[i, j] = (sample(snap, i - 1, j) + sample(snap, i, j + 1)) / F(2.0)
                    elif sm(i + 1, j) == 0 and sm(i, j + 1) == 0:
                        pc[i, j] = (sample(snap, i + 1, j) + sample(snap, i, j + 1)) / F(2.0)
                    elif sm(i - 1, j) == 0 and sm(i, j - 1) == 0:
                        pc[i, j] = (sample(snap, i - 1, j) + sample(snap, i, j - 1)) / F(2.0)
                    elif sm(i + 1, j) == 0 and sm(i, j - 1) == 0:
                        pc[i, j] = (sample(snap, i + 1, j) + sample(snap, i, j - 1)) / F(2.0)
                elif m[i, j] == 2:
                    pc[i, j] = sample(snap, i + 1, j)
                elif m[i, j] == 3:
                    pc[i, j] = F(0.0)

    def set_dye_bc(self, dc):
        m = self.mask
        for i in range(m.shape[0]):
            for j in range(m.shape[1]):
                if m[i, j] == 2:
                    dc[i, j] = self.bc_dye[i, j]

    # ---- pressure solve (fs/pressure_updater.py) -------------------------
    def predict_p(self, pc, vc, i, j):
        sub_x = sample(vc, i + 1, j) - sample(vc, i - 1, j)
        sub_y = sample(vc, i, j + 1) - sample(vc, i, j - 1)
        return (
            F(0.25) * (sample(pc, i + 1, j) + sample(pc, i - 1, j)
                       + sample(pc, i, j + 1) + sample(pc, i, j - 1))
            + (sub_x[0] ** 2 + sub_y[1] ** 2 + (sub_y[0] * sub_x[1])) / F(8.0)
            - self.dx * (sub_x[0] + sub_y[1]) / (F(8) * self.dt)
        )

    def update_pressure(self, vc):
        m = self.mask
        X, Y = m.shape
        for _ in range(self.n_iter):
            self.set_pressure_bc(self.p.cur)
            if self.pressure_solver == "jacobi":
                for i in range(X):
                    for j in range(Y):
                        if m[i, j] != 1:
                            self.p.nxt[i, j] = self.predict_p(self.p.cur, vc, i, j)
            else:
                pn, pc = self.p.nxt, self.p.cur
                om = self.omega
                for i in range(X):  # odd sweep: read cur, write nxt
                    for j in range(Y):
                        if (i + j) % 2 == 1 and m[i, j] == 0:
                            pn[i, j] = (F(1.0) - om) * pc[i, j] + om * self.predict_p(pc, vc, i, j)
                for i in range(X):  # even sweep: read AND write nxt
                    for j in range(Y):
                        if (i + j) % 2 == 0 and m[i, j] == 0:
                            pn[i, j] = (F(1.0) - om) * pn[i, j] + om * self.predict_p(pn, vc, i, j)
            self.p.swap()

    # ---- vorticity confinement (fs/vorticity_confinement.py) -------------
    def apply_confinement(self):
        m = self.mask
        X, Y = m.shape
        vc, vn = self.v.cur, self.v.nxt
        for i in range(X):
            for j in range(Y):
                if m[i, j] == 0:
                    w = diff_x(vc, i, j, self.dx)[1] - diff_y(vc, i, j, self.dx)[0]
                    self.vorticity[i, j] = w
                    self.vorticity_abs[i, j] = abs(w)
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(X):
                for j in range(Y):
                    if m[i, j] == 0:
                        gx = diff_x(self.vorticity_abs, i, j, self.dx)
                        gy = diff_y(self.vorticity_abs, i, j, self.dx)
                        norm = np.sqrt(gx * gx + gy * gy)
                        nx, ny = gx / norm, gy / norm
                        fx = np.fmax(np.fmin(ny * self.vorticity[i, j], F(0.1)), F(-0.1))
                        fy = np.fmax(np.fmin(-nx * self.vorticity[i, j], F(0.1)), F(-0.1))
                        vn[i, j, 0] = vc[i, j, 0] + self.dt * self.vor_eps * fx
                        vn[i, j, 1] = vc[i, j, 1] + self.dt * self.vor_eps * fy
        self.v.swap()

    def limit_field(self):
        vc = self.v.cur
        for i in range(vc.shape[0]):
            for j in range(vc.shape[1]):
                norm = np.sqrt(vc[i, j, 0] ** 2 + vc[i, j, 1] ** 2)
                if norm > self.vlimit:
                    vc[i, j] = self.vlimit * (vc[i, j] / norm)

    # ---- MAC path (fs/solver.py:53-162) ----------------------------------
    def mac_velocity_phase(self):
        m = self.mask
        X, Y = m.shape
        adv = ADVECT[self.scheme]
        self.set_velocity_bc(self.v.cur)
        vc, vn, pc = self.v.cur, self.v.nxt, self.p.cur
        for i in range(X):
            for j in range(Y):
                if m[i, j] == 0:
                    a = adv(vc, vc, i, j, self.dx)
                    gp = np.array([diff_x(pc, i, j, self.dx), diff_y(pc, i, j, self.dx)], dtype=F)
                    lap = (diff2_x(vc, i, j, self.dx) + diff2_y(vc, i, j, self.dx)) / self.re
                    vn[i, j] = vc[i, j] + self.dt * (-a - gp + lap)
        self.v.swap()

    def mac_dye_phase(self):
        m = self.mask
        X, Y = m.shape
        adv = ADVECT[self.scheme]
        self.set_dye_bc(self.dye.cur)
        dc, dn, vcur = self.dye.cur, self.dye.nxt, self.v.cur
        for i in range(X):
            for j in range(Y):
                if m[i, j] == 0:
                    dn[i, j] = dc[i, j] - self.dt * adv(vcur, dc, i, j, self.dx)
        self.dye.swap()
        np.copyto(self.dye.cur, np.fmin(np.fmax(self.dye.cur, F(0.0)), F(1.0)))

    def mac_step(self):
        self.mac_velocity_phase()
        if self.vor_eps is not None:
            self.apply_confinement()
        self.update_pressure(self.v.cur)
        self.limit_field()
        if self.enable_dye:
            self.mac_dye_phase()

    # ---- CIP path (fs/solver.py:165-401) ----------------------------------
    def _non_advection(self, fn, fc, pc, with_pressure):
        m = self.mask
        nch = fn.shape[-1]
        for i in range(m.shape[0]):
            for j in range(m.shape[1]):
                if m[i, j] != 1:
                    lap = (diff2_x(fc, i, j, self.dx) + diff2_y(fc, i, j, self.dx)) / self.re
                    if with_pressure:
                        g = -np.array([diff_x(pc, i, j, self.dx), diff_y(pc, i, j, self.dx)],
                                      dtype=F) + lap
                        fn[i, j] = fc[i, j] + g * self.dt
                    else:
                        fn[i, j] = fc[i, j] + lap * self.dt
        del nch

    def _non_advection_grad(self, fxn, fyn, fxc, fyc, fc, fn):
        m = self.mask
        for i in range(m.shape[0]):
            for j in range(m.shape[1]):
                if m[i, j] != 1:
                    # clamp-to-edge for the reference's direct (UB) reads
                    fxn[i, j] = fxc[i, j] + (
                        sample(fn, i + 1, j) - sample(fc, i + 1, j)
                        - sample(fn, i - 1, j) + sample(fc, i - 1, j)
                    ) / (F(2.0) * self.dx)
                    fyn[i, j] = fyc[i, j] + (
                        sample(fn, i, j + 1) - sample(fc, i, j + 1)
                        - sample(fn, i, j - 1) + sample(fc, i, j - 1)
                    ) / (F(2.0) * self.dx)

    def _cip_advect_cell(self, fn, fxn, fyn, fc, fxc, fyc, v, i, j):
        dx = self.dx
        i_s = int(sgn(v[i, j, 0]))
        j_s = int(sgn(v[i, j, 1]))
        i_m = clamp_idx(fc.shape[0], i - i_s)
        j_m = clamp_idx(fc.shape[1], j - j_s)

        tmp1 = fc[i, j] - fc[i, j_m] - fc[i_m, j] + fc[i_m, j_m]
        tmp2 = fc[i_m, j] - fc[i, j]
        tmp3 = fc[i, j_m] - fc[i, j]

        i_s_denom = F(i_s) * dx**3
        j_s_denom = F(j_s) * dx**3

        a = (F(i_s) * (fxc[i_m, j] + fxc[i, j]) * dx - F(2.0) * (-tmp2)) / i_s_denom
        b = (F(j_s) * (fyc[i, j_m] + fyc[i, j]) * dx - F(2.0) * (-tmp3)) / j_s_denom
        c = (-tmp1 - F(i_s) * (fxc[i, j_m] - fxc[i, j]) * dx) / j_s_denom
        d = (-tmp1 - F(j_s) * (fyc[i_m, j] - fyc[i, j]) * dx) / i_s_denom
        e = (F(3.0) * tmp2 + F(i_s) * (fxc[i_m, j] + F(2.0) * fxc[i, j]) * dx) / dx**2
        f = (F(3.0) * tmp3 + F(j_s) * (fyc[i, j_m] + F(2.0) * fyc[i, j]) * dx) / dx**2
        g = (-(fyc[i_m, j] - fyc[i, j]) + c * dx**2) / (F(i_s) * dx)

        X = -v[i, j, 0] * self.dt
        Y = -v[i, j, 1] * self.dt

        fn[i, j] = (
            ((a * X + c * Y + e) * X + g * Y + fxc[i, j]) * X
            + ((b * Y + d * X + f) * Y + fyc[i, j]) * Y
            + fc[i, j]
        )
        Fx = (F(3.0) * a * X + F(2.0) * c * Y + F(2.0) * e) * X + (d * Y + g) * Y + fxc[i, j]
        Fy = (F(3.0) * b * Y + F(2.0) * d * X + F(2.0) * f) * Y + (c * X + g) * X + fyc[i, j]

        dxv = diff_x(v, i, j, dx)
        dyv = diff_y(v, i, j, dx)
        fxn[i, j] = Fx - self.dt * (Fx * dxv[0] + Fy * dxv[1]) / F(2.0)
        fyn[i, j] = Fy - self.dt * (Fx * dyv[0] + Fy * dyv[1]) / F(2.0)

    def _advection_phase(self, f, fx, fy, v):
        m = self.mask
        for i in range(m.shape[0]):
            for j in range(m.shape[1]):
                if m[i, j] == 0:
                    self._cip_advect_cell(f.nxt, fx.nxt, fy.nxt, f.cur, fx.cur, fy.cur, v, i, j)
        f.swap()
        fx.swap()
        fy.swap()

    def cip_velocity_phase(self):
        self.set_velocity_bc(self.v.cur)
        self._non_advection(self.v.nxt, self.v.cur, self.p.cur, with_pressure=True)
        self._non_advection_grad(self.vx.nxt, self.vy.nxt, self.vx.cur, self.vy.cur,
                                 self.v.cur, self.v.nxt)
        self.v.swap()
        self.vx.swap()
        self.vy.swap()
        self._advection_phase(self.v, self.vx, self.vy, self.v.cur)

    def cip_dye_phase(self):
        self.set_dye_bc(self.dye.cur)
        self._non_advection(self.dye.nxt, self.dye.cur, None, with_pressure=False)
        self._non_advection_grad(self.dyex.nxt, self.dyey.nxt, self.dyex.cur,
                                 self.dyey.cur, self.dye.cur, self.dye.nxt)
        self.dye.swap()
        self.dyex.swap()
        self.dyey.swap()
        self._advection_phase(self.dye, self.dyex, self.dyey, self.v.cur)
        np.copyto(self.dye.cur, np.fmin(np.fmax(self.dye.cur, F(0.0)), F(1.0)))

    def cip_step(self):
        self.cip_velocity_phase()
        if self.vor_eps is not None:
            self.apply_confinement()
        self.update_pressure(self.v.cur)
        self.limit_field()
        if self.enable_dye:
            self.cip_dye_phase()

    def step(self):
        if self.scheme == "cip":
            self.cip_step()
        else:
            self.mac_step()
