"""FE model layer: geometry, sections, boundary conditions, structured
meshing, assembly, the incremental nonlinear solver, homogenization and field
plotting.

The port's copy of ``pylabfea_tpu.femodel`` (host profile): numpy/scipy
float64 with the same arithmetic in the same order, so its fields equal the
JAX package's host solver's.  Behavioral contract follows the reference
``pylabfea.model``.  The implementation replaces the reference's
per-element Python loops with batched array operations:

* stiffness assembly is one batched einsum + ``np.add.at`` scatter
  (reference: triple Python loop, model.py:954-977),
* boundary-condition elimination is a masked matvec (reference: per-node
  list surgery, model.py:1070-1206),
* the material return map runs once per *material group* over all its
  elements via ``Material.response_batch`` (reference: per-element calls,
  model.py:1340-1359).

The card's solver for large meshes lives in
``pylabfea_tpu_torch.ops.fe_kernels`` and ``pylabfea_tpu_torch.parallel``;
``pylabfea_tpu_torch.bridge`` hands a ``Model`` to it.
"""
import warnings

import numpy as np

from pylabfea_tpu_torch.core.tensors import Stress, eps_eq, yf_tolerance


def _halve_increment(d, full, target, applied):
    """Halve the load increment ``d``, clipped (sign-symmetrically) to the
    still-unapplied BC ``target - applied`` and to at least 5% of the full
    increment ``full``.  All arguments are per-direction arrays."""
    d = np.asarray(d, dtype=float)
    s = np.where(np.asarray(full) >= 0., 1., -1.)
    capped = np.minimum(s * (np.asarray(target) - np.asarray(applied)),
                        s * d * 0.5)
    return s * np.maximum(s * 0.05 * np.asarray(full), capped)


class Model(object):
    """Finite element model: pre-processing (geometry, materials, mesh, BCs),
    solution (incremental nonlinear solver) and post-processing
    (homogenization, field plots).

    Boundary conditions on lhs/bottom nodes are static; rhs/top/nodeset loads
    are incremented from zero.  Defaults: lhs fixed in x, bottom fixed in y,
    rhs and top free.

    Parameters
    ----------
    dim : int — dimensionality (1 or 2)
    planestress : bool — plane-stress condition (2-D only)
    """

    def __init__(self, dim=1, planestress=False):
        if dim != 1 and dim != 2:
            raise ValueError('dim must be either 1 or 2')
        self.dim = dim
        if planestress and dim != 2:
            warnings.warn('Warning: Plane stress only defined for 2-d model')
            planestress = False
        self.planestress = planestress
        self.bcl = np.zeros(dim)
        self.bcb = np.zeros(dim)
        self.bct = np.zeros(dim)
        self.bcr = np.zeros(dim)
        self.bcn = np.zeros(dim)
        self.noset = None
        self.ubctop = [False, False]
        self.ubcright = [False, False]
        self.ubcleft = [True, False]
        self.ubcbot = [False, True]
        self.ubcn = [False, False]
        self.nonlin = False
        self.sgl = np.zeros((1, 6))
        self.egl = np.zeros((1, 6))
        self.epgl = np.zeros((1, 6))
        self.u = None
        self.f = None
        self.du = None
        self.Nnode = None
        self.glob = {
            'ebc1': None, 'ebc2': None, 'sbc1': None, 'sbc2': None,
            'eps': np.zeros(6), 'sig': np.zeros(6), 'epl': np.zeros(6),
        }

    # ----------------------
    # element
    # ----------------------
    class Element(object):
        """Isoparametric element: 1-D linear/quadratic or 2-D bilinear quad
        with full Gauss integration; holds B matrices, stiffness, and the
        committed stress/strain state."""

        def __init__(self, model, nodes, lx, ly, mat):
            self.Model = model
            self.nodes = nodes
            self.Lelx = lx
            self.Lely = ly
            self.Mat = mat
            DIM = model.dim
            # Voigt stiffness for plane stress / plane strain
            if model.planestress:
                hh = mat.E / (1 - mat.nu * mat.nu)
                C11 = hh
                C12 = mat.nu * hh
                self.CV = np.zeros((6, 6))
                self.CV[0, 0] = self.CV[1, 1] = C11
                self.CV[0, 1] = self.CV[1, 0] = C12
                self.CV[5, 5] = mat.C44
            elif mat.CV is None:
                self.CV = np.zeros((6, 6))
                self.CV[:3, :3] = mat.C12
                np.fill_diagonal(self.CV[:3, :3], mat.C11)
                self.CV[3, 3] = self.CV[4, 4] = self.CV[5, 5] = mat.C44
            else:
                self.CV = mat.CV
            self.elstiff = self.CV

            self.eps = np.zeros(6)
            self.sig = np.zeros(6)
            self.epl = np.zeros(6)
            self.res_sig = None
            self.res_depl = None

            self.Vel = lx * ly * model.thick
            self.ngp = model.shapefact * DIM ** 2
            self.gpx = np.zeros(self.ngp)
            self.gpy = np.zeros(self.ngp)
            self.Bmat = [None] * self.ngp
            self.wght = 1.
            self.Jac = self.Vel
            self.stat_nlin = {'max_iter': 0, 'max_steps': 0, 'max_dstiff': 0.}

            if model.shapefact == 1:
                if DIM == 1:
                    # B constant over a linear 1-D element
                    self.Bmat[0] = self.calc_Bmat()
                else:
                    # 2-D bilinear quad, 2x2 Gauss integration
                    cpos = np.sqrt(1. / 3.)
                    self.Jac *= 4.
                    for i in range(self.ngp):
                        sx = (-1) ** int(i / 2)
                        sy = (-1) ** i
                        x = 0.5 * (1. + sx * cpos) * self.Lelx
                        y = 0.5 * (1. + sy * cpos) * self.Lely
                        self.gpx[i] = x
                        self.gpy[i] = y
                        self.Bmat[i] = self.calc_Bmat(x=x, y=y)
            elif model.shapefact == 2:
                if DIM == 1:
                    cpos = np.sqrt(1. / 3.)
                    self.wght = 0.5
                    for i in range(self.ngp):
                        sx = (-1) ** i
                        x = 0.5 * self.Lelx * (1. - sx * cpos)
                        self.gpx[i] = x
                        self.Bmat[i] = self.calc_Bmat(x=x)
                else:
                    raise NotImplementedError('Quadrilateral elements with '
                                              'quadratic shape function not '
                                              'implemented')
            self.calc_Kel()

        def calc_Kel(self):
            """Element stiffness by Gauss integration of B^T C B."""
            K0 = sum(B.T @ self.elstiff @ B for B in self.Bmat)
            self.Kel = self.Jac * self.wght * K0

        def node_num(self):
            """Global DOF indices of this element."""
            ind = []
            for j in self.nodes:
                ind.append(j * self.Model.dim)
                if self.Model.dim == 2:
                    ind.append(j * self.Model.dim + 1)
            return ind

        def deps(self):
            """Element-average strain increment from Model.du."""
            du = self.Model.du[self.node_num()]
            deps = 0.
            for B in self.Bmat:
                deps += self.wght * B @ du
            return deps

        def eps_t(self):
            """Element-average total strain from Model.u."""
            u = self.Model.u[self.node_num()]
            et = 0.
            for B in self.Bmat:
                et += self.wght * B @ u
            return et

        def dsig(self):
            """Stress increment with the current tangent stiffness."""
            return self.elstiff @ self.deps()

        def depl(self):
            """Plastic strain increment (zero for elastic materials)."""
            if self.Mat.sy is None:
                return np.zeros(6)
            return self.Mat.epl_dot(self.sig, self.epl, self.CV, self.deps())

        def calc_Bmat(self, x=0., y=0.):
            """B matrix at position (x, y) in the element; for plane stress
            the eps_33 row is eliminated via -nu (sig_1+sig_2)/E."""
            DIM = self.Model.dim
            SF = self.Model.shapefact
            N = DIM * DIM * (SF + 1)
            B = np.zeros((6, N))
            if SF == 1:
                if DIM == 1:
                    hx = 1. / self.Lelx
                    B[0, 0] = -hx
                    B[0, 1] = hx
                else:
                    xi1 = 2. * x / self.Lelx - 1.
                    xi2 = 2. * y / self.Lely - 1.
                    hxm = 0.125 * (1. - xi1) / self.Lely
                    hym = 0.125 * (1. - xi2) / self.Lelx
                    hxp = 0.125 * (1. + xi1) / self.Lely
                    hyp = 0.125 * (1. + xi2) / self.Lelx
                    B[0, 0] = -hym
                    B[0, 2] = -hyp
                    B[0, 4] = hym
                    B[0, 6] = hyp
                    B[1, 1] = -hxm
                    B[1, 3] = hxm
                    B[1, 5] = -hxp
                    B[1, 7] = hxp
                    B[5, 0] = -hxm
                    B[5, 1] = -hym
                    B[5, 2] = hxm
                    B[5, 3] = -hyp
                    B[5, 4] = -hxp
                    B[5, 5] = hym
                    B[5, 6] = hxp
                    B[5, 7] = hyp
                    if self.Model.planestress:
                        hh = self.CV @ B
                        B[2, :] = -self.Mat.nu * (hh[0, :] + hh[1, :]) / self.Mat.E
            elif SF == 2:
                h1 = 1. / self.Lelx
                h2 = 4. / (self.Lelx * self.Lelx)
                if DIM == 1:
                    B[0, 0] = h2 * x - 3. * h1
                    B[0, 1] = 4. * h1 - 2. * h2 * x
                    B[0, 2] = h2 * x - h1
                else:
                    raise NotImplementedError('Quadratic shape functions for '
                                              '2D elements not implemented')
            return B

    # ----------------------
    # pre-processing
    # ----------------------
    def geom(self, sect=1, LX=None, LY=1., LZ=1.):
        """Define model dimensions and its subdivision into sections
        (``sect``: list of absolute section lengths, or an int count)."""
        if type(sect) == list:
            self.Nsec = len(sect)
            self.LS = np.array(sect)
            self.lenx = sum(sect)
        elif type(sect) == int:
            if sect < 1:
                raise ValueError('At least one section must be defined.')
            if LX is None:
                raise ValueError('LX must be given if sect is of type int')
            self.lenx = LX
            self.Nsec = sect
            self.LS = np.ones(sect) * self.lenx / sect
        else:
            raise TypeError(f'Sect must be either list or int, not {type(sect)}')
        self.leny = LY
        self.thick = LZ

    def assign(self, mats):
        """Assign one Material per section; flags the model nonlinear if any
        material is plastic."""
        if len(mats) != self.Nsec:
            raise ValueError(f'Number of materials ({len(mats)}) does not '
                             f'match number of sections ({self.Nsec})')
        self.mat = mats
        self.nonlin = any(mat.sy is not None for mat in mats)

    def _set_bc(self, side, val, bctype, bcdir, allow_force_val=True):
        if isinstance(bcdir, str) and bcdir.lower() == 'x' or bcdir == 0:
            j = 0
        elif isinstance(bcdir, str) and bcdir.lower() == 'y' or bcdir == 1:
            j = 1
        else:
            raise ValueError(f'bc{side}: Unknown value for direction: {bcdir}')
        getattr(self, 'bc' + side[0])[j] = val
        flag = getattr(self, 'ubc' + side)
        if bctype.lower() == 'disp':
            flag[j] = True
        elif bctype.lower() == 'force':
            flag[j] = False
            if not allow_force_val and np.abs(val) > 1.e-6:
                raise ValueError(f'Finite force values at {side} boundary '
                                 'not supported.')
        else:
            raise ValueError(f'bc{side}: Unknown BC: {bctype}')
        return j

    def bcleft(self, val=0., bctype='disp', bcdir='x'):
        """Static BC on lhs nodes (displacement or zero force)."""
        self._set_bc('left', val, bctype, bcdir, allow_force_val=False)

    def bcright(self, val, bctype, bcdir='x'):
        """Incremental BC on rhs nodes (displacement or force)."""
        self._set_bc('right', val, bctype, bcdir)

    def bcbot(self, val=0., bctype='disp', bcdir='y'):
        """Static BC on bottom nodes (displacement or zero force)."""
        if self.dim != 2:
            warnings.warn('BC on bottom nodes will be ignored for 1D model')
        self._set_bc('bot', val, bctype, bcdir, allow_force_val=False)

    def bctop(self, val, bctype, bcdir='y'):
        """Incremental BC on top nodes (displacement or force)."""
        if self.dim != 2:
            warnings.warn('BC on top nodes will be ignored for 1D model')
        self._set_bc('top', val, bctype, bcdir)

    def bcnode(self, node, val, bctype, bcdir):
        """Incremental BC on an explicit node set (call after meshing)."""
        if self.dim != 2:
            warnings.warn('BC on chosen nodes will be ignored for 1D model')
        self.noset = node if type(node) == list else [node]
        self._set_bc('n', val, bctype, bcdir)

    def mesh(self, elmts=None, nodes=None, NX=10, NY=1, SF=1):
        """Generate a structured quad mesh (or import one via ``elmts`` /
        ``nodes``); builds nodes, boundary node lists and elements."""
        self.shapefact = SF
        DIM = self.dim
        if elmts is not None:
            el = np.array(elmts, dtype=int)
            sh = el.shape
            if len(sh) != DIM:
                raise ValueError(f'Cannot use a {sh}-shaped mesh with a '
                                 f'{DIM}-dimensional model')
            NX = sh[0]
            NY = sh[1] if DIM > 1 else 1
        if NX < self.Nsec:
            raise TypeError('Number of elements is smaller than number of '
                            'sections')
        if NY > 1 and DIM == 1:
            NY = 1
            warnings.warn('Warning: NY=1 for 1-d model')
        if self.u is not None:
            warnings.warn('Warning: Solution of previous steps is deleted')
            self.u = None
            self.f = None
        self.NnodeX = self.shapefact * NX + 1
        self.NnodeY = (DIM - 1) * self.shapefact * NY + 1
        self.Nnode = self.NnodeX * self.NnodeY
        self.Ndof = self.Nnode * DIM
        if nodes is None:
            self.npos = np.zeros(self.Ndof)
        else:
            self.npos = np.ravel(nodes, order='C')
            if len(self.npos) != self.Nnode:
                raise ValueError('Inconsistent definition of nodes')
        self.Nel = NX * NY
        if elmts is None:
            self._mesh_structured(NX, NY)
        else:
            self._mesh_imported(el, nodes is not None, NX, NY)
        # cached assembly indices for the batched scatter-add
        self._asm_dofs = np.array([el.node_num() for el in self.element])

    def _grid_boundary_lists(self, ncols, nrow):
        """Boundary / interior node lists of a tensor grid with ``ncols``
        node columns and ``nrow`` node rows, numbered column-major
        (node = col * nrow + row).  Nodes on two boundaries (corners, and
        every node of a 1-D model, where nrow == 1) appear in every list
        they touch."""
        col = np.repeat(np.arange(ncols), nrow)
        row = np.tile(np.arange(nrow), ncols)
        self.noleft = np.flatnonzero(col == 0).tolist()
        self.noright = np.flatnonzero(col == ncols - 1).tolist()
        self.nobot = np.flatnonzero(row == 0).tolist()
        self.notop = np.flatnonzero(row == nrow - 1).tolist()
        inner = ((col > 0) & (col < ncols - 1)
                 & (row > 0) & (row < nrow - 1))
        self.noinner = np.flatnonzero(inner).tolist()

    def _grid_connectivity(self, NX, NY, nrow):
        """Element -> node connectivity of the structured grid, batched.
        Elements are numbered column-major (elem = elcol * NY + elrow); the
        node labels follow the reference element-node convention
        (counter-clockwise for linear quads)."""
        SF = self.shapefact
        ih = np.arange(NX * NY)
        n1 = ((ih // NY) * nrow + ih % NY) * SF
        if self.dim == 1:
            if SF == 1:
                return np.stack([n1, n1 + 1], axis=1)
            return np.stack([n1, n1 + 1, n1 + 2], axis=1)
        return np.stack([n1, n1 + 1, n1 + nrow, n1 + nrow + 1], axis=1)

    def _mesh_structured(self, NX, NY):
        """Structured laminate mesh, built as arrays.

        Each section contributes a proportional number of element columns
        (the widest section absorbs the rounding residue).  Node x
        positions follow the reference convention of scaling the global
        column index by the *owning section's* element width
        (model.py:758-952) — section widths are not accumulated, so the
        positions are only geometrically exact when all sections share the
        same element width.
        """
        DIM, SF = self.dim, self.shapefact
        if DIM == 2 and SF != 1:
            raise NotImplementedError(
                'Quadratic shape functions are only supported for 1-D '
                'structured meshes (use SF=1 in 2-D).')
        nrow = self.NnodeY
        dy = self.leny / NY

        LS = np.asarray(self.LS, dtype=float)
        nes = np.rint(LS * NX / self.lenx).astype(int)
        nes[np.argmax(LS)] += NX - int(nes.sum())
        csum = np.concatenate(([0], np.cumsum(nes)))
        dxs = LS / nes

        # owning section of each node column: the shared column on a
        # section boundary belongs to the section left of it
        gcol = np.arange(self.NnodeX)
        owner = np.searchsorted(SF * csum[1:], gcol, side='left')
        owner = np.minimum(owner, self.Nsec - 1)
        xcol = (gcol - (SF - 1) * csum[owner]) * dxs[owner]

        self.npos = np.zeros(self.Ndof)
        if DIM == 1:
            self.npos[:] = xcol
        else:
            self.npos[0::2] = np.repeat(xcol, nrow)
            self.npos[1::2] = np.tile(np.arange(nrow) * dy, self.NnodeX)

        self._grid_boundary_lists(self.NnodeX, nrow)

        conn = self._grid_connectivity(NX, NY, nrow)
        sec = np.searchsorted(csum[1:], np.arange(self.Nel) // NY,
                              side='right')
        self.element = [self.Element(self, nds, dxs[s], dy, self.mat[s])
                        for nds, s in zip(conn.tolist(), sec.tolist())]

    def _mesh_imported(self, el, have_nodes, NX, NY):
        """Mesh from a user section map ``el`` ((NX, NY) of 1-based section
        numbers) and optional raveled node positions."""
        DIM = self.dim
        nrow = self.NnodeY
        dx = self.lenx / NX
        dy = self.leny / NY
        if not have_nodes:
            xcol = np.arange(self.NnodeX) * dx
            if DIM == 1:
                self.npos[:] = xcol
            else:
                self.npos[0::2] = np.repeat(xcol, nrow)
                self.npos[1::2] = np.tile(np.arange(nrow) * dy, self.NnodeX)
            self._grid_boundary_lists(self.NnodeX, nrow)
        else:
            # classify the raveled position entries by coordinate value;
            # in 2-D even entries are x coordinates, odd entries are y
            # (reference contract, model.py:925-950: the lists then hold
            # per-coordinate entry indices, not node numbers)
            tol = 0.001 * self.lenx / NX
            pos = np.asarray(self.npos)
            idx = np.arange(len(pos))
            if DIM == 2:
                is_x = idx % 2 == 0
                is_y = ~is_x
            else:
                is_x = np.ones(len(pos), dtype=bool)
                is_y = np.zeros(len(pos), dtype=bool)
            lo = pos < tol
            right = (pos > self.lenx - tol) & is_x
            top = (pos > self.leny - tol) & is_y
            self.noleft = idx[lo & is_x].tolist()
            self.nobot = idx[lo & is_y].tolist()
            self.noright = idx[right].tolist()
            self.notop = idx[top].tolist()
            self.noinner = idx[~(lo | right | top)].tolist()
        conn = self._grid_connectivity(NX, NY, nrow)
        sec = np.ravel(el, order='C') - 1
        self.element = [self.Element(self, nds, dx, dy, self.mat[s])
                        for nds, s in zip(conn.tolist(), sec.tolist())]

    # ----------------------
    # assembly & solution
    # ----------------------
    #: above this DOF count the solver switches from dense LU (the
    #: reference contract, used by all regression cases) to sparse CSR +
    #: SuperLU, which scales the host profile to medium meshes
    sparse_threshold = 6000

    def setupK(self):
        """Assemble the global stiffness matrix (batched scatter-add of all
        element stiffness matrices); sparse CSR above ``sparse_threshold``
        DOFs."""
        Kels = np.stack([el.Kel for el in self.element])
        rows = self._asm_dofs
        if self.Ndof > self.sparse_threshold:
            from scipy import sparse
            nn = rows.shape[1]
            ri = np.repeat(rows, nn, axis=1).ravel()
            ci = np.tile(rows, (1, nn)).ravel()
            K = sparse.coo_matrix((Kels.ravel(), (ri, ci)),
                                  shape=(self.Ndof, self.Ndof)).tocsr()
            return K
        K = np.zeros((self.Ndof, self.Ndof))
        np.add.at(K, (rows[:, :, None], rows[:, None, :]), Kels)
        return K

    @staticmethod
    def _solve_reduced(K, ind, rhs):
        """Solve the BC-reduced system for the free DOFs ``ind``."""
        from scipy import sparse
        if sparse.issparse(K):
            from scipy.sparse.linalg import spsolve
            Kr = K[ind, :][:, ind].tocsc()
            return spsolve(Kr, rhs)
        return np.linalg.solve(K[np.ix_(ind, ind)], rhs)

    def _calc_BC(self, K, bcl0, bcb0, dbcr, dbct, dbcn):
        """Apply BCs: returns (du with prescribed values, consistent force
        increment df, list of free DOFs).  Displacement BCs eliminate rows
        (masked matvec); force BCs are distributed over boundary nodes with
        half weight at corners."""
        du = np.zeros(self.Ndof)
        df = np.zeros(self.Ndof)
        mask = np.zeros(self.Ndof, dtype=bool)

        def fix(nodes, k, val, who):
            for j in nodes:
                i = int(np.ravel(j)[0]) * self.dim + k
                if not mask[i]:
                    mask[i] = True
                    du[i] = val
                elif du[i] != val:
                    warnings.warn(f'Inconsistent BC at {who} node {j} '
                                  f'({du[i]} vs {val}).')

        for k in range(self.dim):
            if self.ubcleft[k]:
                fix(self.noleft, k, bcl0[k], 'left')
        if self.dim == 2:
            for k in range(self.dim):
                if self.ubcbot[k]:
                    fix(self.nobot, k, bcb0[k], 'bottom')
        for k in range(self.dim):
            if self.ubcright[k]:
                fix(self.noright, k, dbcr[k], 'right')
            else:
                for j in self.noright:
                    i = j * self.dim + k
                    if self.NnodeY > 1:
                        hh = 1. / (self.NnodeY - 1)
                        hy = self.npos[j * self.dim + 1]
                        if hy < 1.e-3 or hy > self.leny - 1.e-3:
                            hh *= 0.5
                    else:
                        hh = 1.
                    df[i] += dbcr[k] * hh
        if self.dim == 2:
            for k in range(self.dim):
                if self.ubctop[k]:
                    fix(self.notop, k, dbct[k], 'top')
                else:
                    for j in self.notop:
                        i = j * self.dim + k
                        hh = 1. / (self.NnodeX - 1)
                        hx = self.npos[j * self.dim]
                        if hx < 1.e-3 or hx > self.lenx - 1.e-3:
                            hh *= 0.5
                        df[i] += dbct[k] * hh
        if self.dim == 2 and self.noset is not None:
            if dbcn is None:
                raise ValueError('No BC for selected node set given.')
            for k in range(self.dim):
                if self.ubcn[k]:
                    fix(self.noset, k, dbcn[k], 'node set')
                else:
                    for j in self.noset:
                        i = int(np.ravel(j)[0]) * self.dim + k
                        df[i] += dbcn[k]
        # consistent forces from prescribed displacements
        if mask.any():
            df -= K @ (du * mask)
        ind = np.nonzero(~mask)[0]
        return du, df, list(ind)

    def _calc_scf(self, sld, verb):
        """Load-step scaling so no element overshoots the yield surface.
        Reproduces the reference statistics (min vs. mean-std selection and
        the double append for elements starting well inside the elastic
        regime, model.py:1036-1067)."""
        # element strain/stress increments, batched per material group
        dsig_all = np.array([el.dsig() for el in self.element])
        sc_list = []
        groups = {}
        for ie, el in enumerate(self.element):
            groups.setdefault(id(el.Mat), (el.Mat, []))[1].append(ie)
        sref_all = np.zeros(self.Nel)
        yf0_all = np.zeros(self.Nel)
        for mat, idx in groups.values():
            idx = np.array(idx)
            sref_all[idx] = np.atleast_1d(mat.calc_seq(dsig_all[idx]))
            if mat.sy is not None:
                sig_rows = np.array([self.element[i].sig for i in idx])
                epl_rows = np.array([self.element[i].epl for i in idx])
                yf0_all[idx] = np.atleast_1d(mat._yf_rows(sig_rows, epl_rows))
                need = (sref_all[idx] > 0.1) & (yf0_all[idx] < -0.15)
                if mat.ML_yf and need.any():
                    k = idx[need]
                    yf0_all[k] = mat._ml_full_yf_rows(
                        sig_rows[need], epl_rows[need], ld=sld, verb=verb)
        for ie, el in enumerate(self.element):
            sref = sref_all[ie]
            if el.Mat.sy is not None and sref > 0.1:
                yf0 = yf0_all[ie]
                if yf0 < -0.15:
                    hh = np.minimum(1., -yf0 / sref)
                    sc_list.append(hh)
                else:
                    hh = np.minimum(1., np.sqrt(1.5) *
                                    el.Mat.get_sflow(eps_eq(el.epl)) / sref)
                sc_list.append(hh)
        if len(sc_list) == 0:
            sc_list = [1.]
        hh = np.std(sc_list)
        if hh < 0.1:
            scf = np.amin(sc_list)
        else:
            scf = np.maximum(1.e-3, np.mean(sc_list) - hh)
        if scf < 1.e-3:
            if verb:
                warnings.warn(f'Warning: Small load increment in calc_scf: {scf}')
            scf = 1.e-3
        return scf

    def solve(self, min_step=None, verb=False):
        """Incremental solution of K.u = f under the applied BCs.  Elastic
        predictor + batched material response per material group; load
        increments are scaled to hit the yield surface and halved on
        non-convergence; element tangent stiffnesses are updated until the
        global stiffness matrix is self-consistent."""
        if self.Nnode is None:
            raise AttributeError('Attributes for mesh not set, but required '
                                 'by solver.')

        if self.u is None:
            self.u = np.zeros(self.Ndof)
            self.f = np.zeros(self.Ndof)
            self.sgl = np.zeros((1, 6))
            self.egl = np.zeros((1, 6))
            self.epgl = np.zeros((1, 6))
            for el in self.element:
                el.elstiff = el.CV
                el.calc_Kel()
                el.eps = np.zeros(6)
                el.sig = np.zeros(6)
                el.epl = np.zeros(6)
            bcr0 = np.zeros(self.dim)
            bct0 = np.zeros(self.dim)
            self.bct_mem = np.zeros(self.dim)
            self.bcr_mem = np.zeros(self.dim)
            if self.noset is not None:
                bcn0 = np.zeros(self.dim)
                self.bcn_mem = np.zeros(self.dim)
        else:
            bcr0 = self.bcr_mem
            bct0 = self.bct_mem
            if self.noset is not None:
                bcn0 = self.bcn_mem
        bcl0 = self.bcl
        bcb0 = self.bcb
        K = self.setupK()

        # loading-direction Voigt tensor (for ML yield-locus searches)
        sld = np.zeros(6)
        if np.abs(self.bcr[0]) > 1.e-6:
            sld[0] = np.sign(self.bcr[0])
        if self.dim > 1:
            if np.abs(self.bct[1]) > 1.e-6:
                sld[1] = np.sign(self.bct[1])
            if np.abs(self.bcr[1]) > 1.e-6:
                sld[5] = np.sign(self.bcr[1])
        if np.abs(self.bct[0]) > 1.e-6:
            sld[5] = np.sign(self.bct[0])
        if np.linalg.norm(sld) < 1.e-3:
            warnings.warn(f'solve: inconsistent BC sld={sld}, bct={self.bct}, '
                          f'bcr={self.bcr}')
            sld[0] = 1.

        # material groups of plastic elements for the batched return map
        plast_groups = {}
        for ie, el in enumerate(self.element):
            if el.Mat.sy is not None:
                plast_groups.setdefault(id(el.Mat), (el.Mat, []))[1].append(ie)

        il = 0
        nit = 0
        niter = []
        co_nconv = []
        bc_inc = True
        nconv = 0
        while bc_inc:
            max_dbct = self.bct - bct0
            max_dbcr = self.bcr - bcr0
            if min_step is not None:
                sc = np.maximum(1, min_step - il)
                max_dbct = max_dbct / sc
                max_dbcr = max_dbcr / sc
            dbcr = np.array(max_dbcr)
            dbct = np.array(max_dbct)
            if self.noset is not None:
                max_dbcn = self.bcn - bcn0
                if min_step is not None:
                    max_dbcn = max_dbcn / np.maximum(1, min_step - il)
                dbcn = np.array(max_dbcn)
            else:
                max_dbcn = None
                dbcn = None

            self.du, df, ind = self._calc_BC(K, bcl0, bcb0, dbcr, dbct, dbcn)
            self.du[ind] = self._solve_reduced(K, ind, df[ind])

            if self.nonlin:
                scale_bc = (self._calc_scf(sld, verb) if il < 10 else 1.)
                dbcr = max_dbcr * scale_bc
                dbct = max_dbct * scale_bc
                nit = 0
                change = True
                conv = False
                if verb:
                    print('***Load step #', il, 'scaling factor', scale_bc)
                while (change or not conv) and nit <= 15:
                    if il < 6 and nit > 1:
                        # halve the load increments to force convergence,
                        # clipped to the remaining BC and to >= 5% of the
                        # full increment
                        dbcr = _halve_increment(dbcr, max_dbcr, self.bcr, bcr0)
                        dbct = _halve_increment(dbct, max_dbct, self.bct, bct0)
                        if self.noset is not None:
                            dbcn = _halve_increment(dbcn, max_dbcn,
                                                    self.bcn, bcn0)
                    K = self.setupK()
                    self.du, df, ind = self._calc_BC(K, bcl0, bcb0, dbcr,
                                                     dbct, dbcn)
                    self.du[ind] = self._solve_reduced(K, ind, df[ind])

                    # material response, batched per material group
                    f = np.zeros(self.Nel)
                    change = False
                    for mat, idx in plast_groups.values():
                        idx_a = np.array(idx)
                        sig_rows = np.array([self.element[i].sig for i in idx])
                        epl_rows = np.array([self.element[i].epl for i in idx])
                        deps_rows = np.array([self.element[i].deps()
                                              for i in idx])
                        CV = self.element[idx[0]].CV
                        fyld, res_sig, res_depl, gr_stiff, nst = \
                            mat.response_batch(sig_rows, epl_rows, deps_rows, CV)
                        f[idx_a] = fyld / mat._sflow_rows(epl_rows)
                        for jj, i in enumerate(idx):
                            el = self.element[i]
                            el.res_sig = res_sig[jj]
                            el.res_depl = res_depl[jj]
                            el.res_deps = deps_rows[jj]
                            hh = np.linalg.norm(el.elstiff - gr_stiff[jj])
                            if hh > 1.e-3:
                                if nit < 15:
                                    el.elstiff = gr_stiff[jj]
                                else:
                                    el.elstiff = 0.5 * (gr_stiff[jj] + el.elstiff)
                                el.calc_Kel()
                                change = True
                            el.stat_nlin['max_steps'] = np.maximum(
                                nst[jj], el.stat_nlin['max_steps'])
                            el.stat_nlin['max_dstiff'] = np.maximum(
                                hh, el.stat_nlin['max_dstiff'])
                    conv = np.all(f <= yf_tolerance * 1.0001)
                    if verb:
                        print('+++Inner trial step #', nit)
                        print('load increment right:', dbcr)
                        print('load increment top:', dbct)
                        if not conv:
                            print('  ### No convergence of plasticity '
                                  'algorithm in trial step #', nit)
                    if not conv:
                        nconv += 1
                    nit += 1
            # update internal variables with results of load step
            self.u += self.du
            self.f += K @ self.du
            for el in self.element:
                if el.res_sig is None:
                    el.epl = el.epl + el.depl()
                    el.sig = el.sig + el.dsig()
                else:
                    el.epl = el.epl + el.res_depl
                    el.sig = np.array(el.res_sig)
                el.eps = el.eps_t()

            il += 1
            niter.append(nit - 1)
            co_nconv.append(nconv)
            bcr0 = bcr0 + dbcr
            hl0 = np.abs(bcr0[0] - self.bcr[0]) > 1.e-6 and np.abs(self.bcr[0]) > 1.e-9
            if self.dim > 1:
                hl1 = np.abs(bcr0[1] - self.bcr[1]) > 1.e-6 and np.abs(self.bcr[1]) > 1.e-9
                bct0 = bct0 + dbct
                hr0 = np.abs(bct0[0] - self.bct[0]) > 1.e-6 and np.abs(self.bct[0]) > 1.e-9
                hr1 = np.abs(bct0[1] - self.bct[1]) > 1.e-6 and np.abs(self.bct[1]) > 1.e-9
                if self.noset is not None:
                    bcn0 = bcn0 + dbcn
                    hr0 = hr0 or (np.abs(bcn0[0] - self.bcn[0]) > 1.e-6 and
                                  np.abs(self.bcn[0]) > 1.e-9)
                    hr1 = hr1 or (np.abs(bcn0[1] - self.bcn[1]) > 1.e-6 and
                                  np.abs(self.bcn[1]) > 1.e-9)
            else:
                hl1 = hr0 = hr1 = False
            bc_inc = hr0 or hr1 or hl0 or hl1
            self.calc_global()
            self.sgl = np.append(self.sgl, [self.glob['sig']], axis=0)
            self.egl = np.append(self.egl, [self.glob['eps']], axis=0)
            self.epgl = np.append(self.epgl, [self.glob['epl']], axis=0)
            if verb:
                print('Load increment ', il, 'total', self.ubctop, 'top ',
                      bct0, '/', self.bct, '; last step ', dbct)
                print('Load increment ', il, 'total', self.ubcright, 'rhs',
                      bcr0, '/', self.bcr, '; last step ', dbcr)
                print('Global strain: ', np.around(self.glob['eps'], decimals=5))
                print('Global stress: ', np.around(self.glob['sig'], decimals=3))
                print('Global plastic strain: ',
                      np.around(self.glob['epl'], decimals=6))
                print('----------------------------')
        self.bct_mem = bct0
        self.bcr_mem = bcr0
        if self.noset is not None:
            self.bcn_mem = bcn0
        self.nsteps = il
        self.niter = niter
        self.co_nconv = co_nconv

    # ----------------------
    # post-processing
    # ----------------------
    def bcval(self, nodes):
        """Average displacement and total force over a node list."""
        n = len(nodes)
        nodes = np.asarray(nodes, dtype=int)
        hux = np.sum(self.u[nodes * self.dim])
        hfx = np.sum(self.f[nodes * self.dim])
        if self.dim == 2:
            huy = np.sum(self.u[nodes * self.dim + 1])
            hfy = np.sum(self.f[nodes * self.dim + 1])
        else:
            huy = hfy = 0.
        return hux / n, huy / n, hfx, hfy

    def calc_global(self):
        """Homogenize: global strain/stress from opposing boundary-node
        pairs (``ebc*``/``sbc*`` keys) and volume-averaged element solutions
        (``sig``/``eps``/``epl``)."""
        # (key suffix for normal / shear components, low side, high side,
        #  gauge length, traction area) per opposing boundary pair
        pairs = [(('1', '21'), self.noleft, self.noright, 0,
                  self.lenx, self.leny * self.thick)]
        if self.dim == 2:
            pairs.append((('2', '12'), self.nobot, self.notop, 1,
                          self.leny, self.lenx * self.thick))
        for (kn, ks), lo, hi, normal, length, area in pairs:
            u_lo = np.array(self.bcval(lo))
            u_hi = np.array(self.bcval(hi))
            du, df = u_hi[:2] - u_lo[:2], u_hi[2:] - u_lo[2:]
            shear = 1 - normal
            self.glob['ebc' + kn] = du[normal] / length
            self.glob['sbc' + kn] = 0.5 * df[normal] / area
            self.glob['ebc' + ks] = du[shear] / length
            self.glob['sbc' + ks] = 0.5 * df[shear] / area
        vol = np.array([e.Vel for e in self.element])
        Vm = self.lenx * self.leny * self.thick
        for key in ('sig', 'eps', 'epl'):
            rows = np.array([getattr(e, key) for e in self.element])
            self.glob[key] = vol @ rows / Vm

    def plot(self, fsel, mag=10, colormap='viridis', cdepth=20, showmesh=True,
             shownodes=True, vmin=None, vmax=None, annot=True, file=None,
             showfig=True, pos_bar=0.83, fig=None, ax=None, showbar=True):
        """Plot a field variable on the deformed mesh.  Field selectors:
        strain1/2/12, stress1/2/12, plastic1/2/12, seq, seqJ2, peeq, etot,
        ux, uy, mat."""
        import matplotlib.pyplot as plt
        from matplotlib import cm, colors
        from matplotlib.collections import PolyCollection

        if fig is None:
            fig, ax = plt.subplots(1)
        elif ax is None:
            raise ValueError('Figure handle provided but no axis handle.')
        cmap = plt.get_cmap(colormap, cdepth)

        def elvals(fn, scale=1., label=''):
            return [fn(el) * scale for el in self.element], label

        def disp_avg(comp):
            hh = np.zeros(self.Nel)
            for ie, el in enumerate(self.element):
                fac = 1.0 / len(el.nodes)
                for nn in el.nodes:
                    hh[ie] += self.u[nn * self.dim + comp] * fac
            return hh

        field = {
            'strain1': lambda: elvals(lambda e: e.eps[0], 100.,
                                      r'$\epsilon^\mathrm{tot}_{11}$ (%)'),
            'strain2': lambda: elvals(lambda e: e.eps[1], 100.,
                                      r'$\epsilon^\mathrm{tot}_{22}$ (%)'),
            'strain12': lambda: elvals(lambda e: e.eps[5], 100.,
                                       r'$\epsilon^\mathrm{tot}_{12}$ (%)'),
            'stress1': lambda: elvals(lambda e: e.sig[0], 1.,
                                      r'$\sigma_{11}$ (MPa)'),
            'stress2': lambda: elvals(lambda e: e.sig[1], 1.,
                                      r'$\sigma_{22}$ (MPa)'),
            'stress12': lambda: elvals(lambda e: e.sig[5], 1.,
                                       r'$\sigma_{12}$ (MPa)'),
            'plastic1': lambda: elvals(lambda e: e.epl[0], 100.,
                                       r'$\epsilon^\mathrm{pl}_{11}$ (%)'),
            'plastic2': lambda: elvals(lambda e: e.epl[1], 100.,
                                       r'$\epsilon^\mathrm{pl}_{22}$ (%)'),
            'plastic12': lambda: elvals(lambda e: e.epl[5], 100.,
                                        r'$\epsilon^\mathrm{pl}_{12}$ (%)'),
            'seq': lambda: elvals(lambda e: Stress(e.sig).seq(e.Mat), 1.,
                                  r'$\sigma_{eq}$ (MPa)'),
            'seqJ2': lambda: elvals(lambda e: Stress(e.sig).seq_j2(), 1.,
                                    r'$\sigma^\mathrm{J2}_{eq}$ (MPa)'),
            'peeq': lambda: elvals(lambda e: eps_eq(e.epl), 100.,
                                   r'$\epsilon^\mathrm{pl}_{eq}$ (%)'),
            'etot': lambda: elvals(lambda e: eps_eq(e.eps), 100.,
                                   r'$\epsilon^\mathrm{tot}_{eq}$ (%)'),
            'ux': lambda: (disp_avg(0), r'$u_x$ (mm)'),
            'uy': lambda: (disp_avg(1), r'$u_y$ (mm)'),
            'mat': lambda: elvals(lambda e: e.Mat.num, 1., 'Material number'),
        }
        val, text_cb = field[fsel]()
        val = np.asarray(val, dtype=float)
        lo = np.amin(val) if vmin is None else vmin
        hi = np.amax(val) if vmax is None else vmax
        degenerate = abs(hi - lo) < 0.1 or hi < 0. \
            or (hi > 0. and abs(hi - lo) < 0.04 * hi)
        if vmin is None and vmax is None and degenerate:
            # degenerate auto range: pad near-zero fields by an absolute
            # +-0.05, otherwise widen both bounds by 2% of their magnitude
            if abs(hi) < 0.1:
                lo, hi = lo - 0.05, hi + 0.05
            elif hi > 0.:
                lo, hi = 0.98 * lo, 1.02 * hi
            else:
                lo, hi = 1.02 * lo, 0.98 * hi
        shade = np.round((val - lo) / abs(hi - lo), decimals=5)

        pos = np.asarray(self.npos, dtype=float)
        if mag > 0. and self.u is not None:
            pos = pos + mag * np.asarray(self.u)
        if self.dim == 1:
            # each bar element becomes a thick rectangle around the x axis
            half = 0.5 * self.thick
            quads = np.empty((self.Nel, 4, 2))
            for ie, el in enumerate(self.element):
                xl, xr = pos[min(el.nodes)], pos[max(el.nodes)]
                quads[ie, :, 0] = (xl, xr, xr, xl)
                quads[ie, :, 1] = (-half, -half, half, half)
            node_x, node_y = pos, np.zeros_like(pos)
        else:
            xy = pos.reshape(-1, 2)
            # connectivity row (n0, n1, n2, n3) in counter-clockwise
            # perimeter order for the quad patch
            ring = np.array([(el.nodes[0], el.nodes[2], el.nodes[3],
                              el.nodes[1]) for el in self.element])
            quads = xy[ring]
            node_x, node_y = xy[:, 0], xy[:, 1]
        patches = PolyCollection(
            quads, facecolors=cmap(shade),
            edgecolors='black' if showmesh else 'none',
            linewidths=1. if showmesh else 0.)
        ax.add_collection(patches)
        ax.autoscale_view()
        if shownodes:
            ax.plot(node_x, node_y, 'o', color='red', markersize=7, zorder=3)
        if showbar:
            cax = fig.add_axes((pos_bar, 0.15, 0.04, 0.7))
            sm = cm.ScalarMappable(
                cmap=cmap, norm=colors.Normalize(vmin=lo, vmax=hi))
            fig.colorbar(sm, cax=cax, orientation='vertical', label=text_cb)
        if annot:
            ax.set_xlabel('x (mm)')
            ax.set_ylabel('y (mm)')
        ax.set_aspect('equal', 'box')
        if file is not None:
            fig.savefig(file + '.pdf', format='pdf', dpi=300)
        if showfig:  # pragma: no cover
            import matplotlib.pyplot as plt
            plt.show()
        else:
            return fig, ax
