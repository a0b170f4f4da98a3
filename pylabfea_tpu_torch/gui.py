"""Minimal tkinter GUI: composite (elastic-plastic inclusion) model
parameter form; builds the model, solves, and shows field plots.

The port's copy of ``pylabfea_tpu.gui`` (host profile).  Reference
parity (the reference ``pylabfea`` ``gui.py``): an
elastic-plastic composite — J2 matrix with isotropic hardening
(``gui.py:140``) around a purely elastic filler phase — with a lateral
boundary-condition selector (force-free vs fixed-displacement sides,
``gui.py:88-92``).  Unlike the reference (which runs ``app.mainloop()``
at import), the app only starts when ``main()`` is called::

    python -m pylabfea_tpu_torch.gui

The model construction lives in :func:`build_composite_model` so the
physics is testable headless (no tkinter required).
"""
import numpy as np


def self_closing_message(msg, timeout=2000):
    import tkinter as tk
    root = tk.Tk()
    root.title("Info")
    tk.Label(root, text=msg, padx=20, pady=20).pack()
    root.after(timeout, root.destroy)
    root.mainloop()


def add_label_and_entry(frame, row, text, default):
    import tkinter as tk
    tk.Label(frame, text=text).grid(row=row, column=0, sticky='w')
    var = tk.StringVar(value=str(default))
    tk.Entry(frame, textvariable=var, width=12).grid(row=row, column=1)
    return var


def build_composite_model(NX=18, E1=10.e3, nu1=0.27, E2=300.e3, nu2=0.3,
                          sy1=150., khard1=500., strain=0.01,
                          sides='force'):
    """Two-section inclusion model of the GUI (reference gui.py:128-166):
    an elastic-plastic J2+hardening matrix (material 1) with a centered
    square elastic filler (material 2), stretched in y.  ``sides``
    selects the lateral BC: ``'force'`` (free sides; the bottom-left
    corner node is pinned in x against rigid-body motion) or ``'disp'``
    (laterally fixed sides).  Pass ``sy1=None`` for an all-elastic
    matrix.  Returns the meshed, unsolved model."""
    if sides not in ('force', 'disp'):
        raise ValueError(f"sides must be 'force' or 'disp', got {sides!r}")
    import pylabfea_tpu_torch as FE
    NY = NX
    n1, n2 = NX // 3, 2 * (NX // 3)
    el = np.ones((NX, NY))
    el[n1:n2, n1:n2] = 2
    mat1 = FE.Material(num=1)
    mat1.elasticity(E=E1, nu=nu1)
    if sy1 is not None:
        mat1.plasticity(sy=sy1, khard=khard1, sdim=6)
    mat2 = FE.Material(num=2)
    mat2.elasticity(E=E2, nu=nu2)
    fe = FE.Model(dim=2, planestress=False)
    fe.geom(sect=2, LX=4., LY=4.)
    fe.assign([mat1, mat2])
    fe.bcbot(0.)
    fe.bcright(0., sides)
    fe.bcleft(0., sides)
    fe.bctop(strain * fe.leny, 'disp')
    fe.mesh(elmts=el, NX=NX, NY=NY)
    if sides == 'force':
        hh = [no in fe.nobot for no in fe.noleft]
        noc = np.nonzero(hh)[0]
        fe.bcnode(noc, 0., 'disp', 'x')  # fix corner against rigid motion
    return fe


class UserInterface:
    """Parameter form for a 2-section elastic-plastic inclusion model."""

    def __init__(self, master):
        import tkinter as tk
        from tkinter import ttk
        self.master = master
        master.title("pylabfea_tpu_torch — composite model")
        frame = tk.Frame(master, padx=10, pady=10)
        frame.pack()
        self.e_mat = add_label_and_entry(frame, 0, "E matrix (MPa)", 10.e3)
        self.nu_mat = add_label_and_entry(frame, 1, "nu matrix", 0.27)
        self.sy_mat = add_label_and_entry(frame, 2,
                                          "yield strength matrix (MPa)",
                                          150.)
        self.khard_mat = add_label_and_entry(frame, 3,
                                             "hardening modulus (MPa)", 500.)
        self.e_inc = add_label_and_entry(frame, 4, "E filler (MPa)", 300.e3)
        self.nu_inc = add_label_and_entry(frame, 5, "nu filler", 0.3)
        self.nel = add_label_and_entry(frame, 6, "elements per side", 18)
        self.strain = add_label_and_entry(frame, 7, "applied strain", 0.01)
        # lateral-BC selector (reference gui.py:88-92): 'force' = free
        # sides, 'disp' = laterally fixed sides
        tk.Label(frame, text="Lateral BC").grid(row=8, column=0, sticky='w')
        self.sides = tk.StringVar(value='force')
        ttk.Combobox(frame, textvariable=self.sides,
                     values=('force', 'disp'), state='readonly',
                     width=10).grid(row=8, column=1)
        tk.Button(frame, text="Run", command=self.run).grid(row=9, column=0)
        tk.Button(frame, text="Quit", command=master.destroy).grid(row=9,
                                                                   column=1)

    def run(self):
        sy = float(self.sy_mat.get())
        fe = build_composite_model(
            NX=int(self.nel.get()),
            E1=float(self.e_mat.get()), nu1=float(self.nu_mat.get()),
            E2=float(self.e_inc.get()), nu2=float(self.nu_inc.get()),
            sy1=sy if sy > 0. else None,
            khard1=float(self.khard_mat.get()),
            strain=float(self.strain.get()),
            sides=self.sides.get())
        fe.plot('mat', mag=1, shownodes=False)
        fe.solve()
        for fsel in ('stress1', 'stress2', 'seq', 'peeq', 'ux'):
            fe.plot(fsel, mag=4, shownodes=False)


def main():  # pragma: no cover
    import tkinter as tk
    root = tk.Tk()
    UserInterface(root)
    root.mainloop()


if __name__ == '__main__':  # pragma: no cover
    main()
