"""Generate the runnable .ipynb twins of the reference's three notebooks, and run them.

Port of `examples/make_notebooks.py`: diffedit_inpaint.ipynb,
score_sde_demo.ipynb and latent_imagenet_diffusion.ipynb (the reference's
diffedit_inpaint.ipynb, Score_SDE_demo_PyTorch.ipynb and
latent_imagenet_diffusion.ipynb). Each wraps one demo of this package in
four cells: a markdown introduction (the demo's docstring), a parameters
cell, a run cell that runs the demo in-process with
`runpy.run_module(..., run_name="__main__")` (whatever the working
directory), and a display cell. The demos run on the card by default;
`--device cpu` in ARGS runs them on the host, and `--ckpt` (with `--clip`
for DiffEdit) loads real weights in place of the tiny random-weight bundle.

Regenerate next to this file (or into OUTDIR) with:
    python -m dpm_solver_tpu_torch.examples.make_notebooks [OUTDIR]
`run_notebook` executes a notebook's code cells without Jupyter.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "dpm_solver_tpu_torch.examples"


def cells_for(demo, params, title, ref):
    with open(os.path.join(HERE, demo + ".py")) as f:
        doc = f.read().split('"""')[1].strip()
    md = f"# {title}\n\nNotebook twin of the reference `{ref}`.\n\n" + doc
    param_src = "\n".join(
        ["import os, tempfile", f"MODULE = '{PACKAGE}.{demo}'"] + params
        + ["# the card by default: add '--device', 'cpu' to ARGS to run on the host"])
    run_src = (
        "import runpy, sys\n"
        "sys.argv = [MODULE] + ARGS\n"
        "runpy.run_module(MODULE, run_name='__main__')\n"
    )
    show_src = (
        "# display the artifacts the run wrote (PNG grids / edited images)\n"
        "import glob, os\n"
        "from IPython.display import Image, display\n"
        "for p in sorted(glob.glob(os.path.join(OUTDIR, '*.png')))[:8]:\n"
        "    print(p)\n"
        "    display(Image(filename=p))\n"
    )

    def code(srctext):
        return {"cell_type": "code", "execution_count": None,
                "metadata": {}, "outputs": [],
                "source": srctext.splitlines(keepends=True)}

    return [
        {"cell_type": "markdown", "metadata": {},
         "source": md.splitlines(keepends=True)},
        code(param_src),
        code(run_src),
        code(show_src),
    ]


NOTEBOOKS = {
    "diffedit_inpaint.ipynb": dict(
        demo="diffedit_demo",
        title="DiffEdit: mask-free prompt-to-prompt editing",
        ref="examples/stable-diffusion/scripts/diffedit_inpaint.ipynb",
        params=[
            "OUTDIR = os.path.join(tempfile.gettempdir(), 'diffedit_demo')",
            "# pass '--ckpt' (an SD checkpoint) and '--clip' (a CLIP directory) for real",
            "# weights; a tiny random-weight bundle otherwise",
            "ARGS = ['--outdir', OUTDIR,",
            "        '--src', 'a bowl of apples',",
            "        '--dst', 'a bowl of oranges']",
        ]),
    "score_sde_demo.ipynb": dict(
        demo="score_sde_demo",
        title="Score SDE sampling (PC / ODE / DPM-Solver)",
        ref="examples/score_sde_pytorch/Score_SDE_demo_PyTorch.ipynb",
        params=[
            "OUTDIR = os.path.join(tempfile.gettempdir(), 'score_sde_demo')",
            "# pass '--ckpt' (a score_sde_pytorch .pth) for real weights; a tiny",
            "# random-weight NCSN++ otherwise",
            "ARGS = ['--outdir', OUTDIR]",
        ]),
    "latent_imagenet_diffusion.ipynb": dict(
        demo="latent_imagenet_demo",
        title="Class-conditional latent diffusion (cin256)",
        ref="examples/stable-diffusion/scripts/latent_imagenet_diffusion.ipynb",
        params=[
            "OUTDIR = os.path.join(tempfile.gettempdir(), 'latent_imagenet_demo')",
            "# pass '--ckpt' (a CompVis cin256 checkpoint) for real weights; a tiny",
            "# random-weight bundle otherwise",
            "ARGS = ['--outdir', OUTDIR]",
        ]),
}


def notebook(spec) -> dict:
    return {
        "cells": cells_for(spec["demo"], spec["params"], spec["title"], spec["ref"]),
        "metadata": {"kernelspec": {"display_name": "Python 3",
                                    "language": "python",
                                    "name": "python3"},
                     "language_info": {"name": "python"}},
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def run_notebook(path, args=(), outdir=None) -> dict:
    """Execute the code cells of the notebook at `path` in order, in one
    namespace, as a kernel would (the notebook read as plain JSON). `args`
    go after the parameters cell's ARGS (argparse keeps an option's last
    value); `outdir` replaces its OUTDIR. The display cell runs only where
    IPython imports. Returns the namespace; its "DISPLAYED" says whether the
    display cell ran. `sys.argv` is restored afterwards."""
    with open(path) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    try:
        import IPython  # noqa: F401
        displays = True
    except ImportError:
        displays = False
    ns = {"__name__": "__main__", "DISPLAYED": False}
    argv = sys.argv
    try:
        for i, cell in enumerate(cells):
            src = "".join(cell["source"])
            if "IPython" in src:
                if not displays:
                    continue
                ns["DISPLAYED"] = True
            exec(compile(src, f"{os.path.basename(path)}[{i}]", "exec"), ns)
            if i == 0:   # the parameters cell
                if outdir is not None:
                    ns["OUTDIR"] = str(outdir)
                    ns["ARGS"] = ns["ARGS"] + ["--outdir", str(outdir)]
                ns["ARGS"] = ns["ARGS"] + [str(a) for a in args]
    finally:
        sys.argv = argv
    return ns


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else HERE
    os.makedirs(outdir, exist_ok=True)
    for name, spec in NOTEBOOKS.items():
        path = os.path.join(outdir, name)
        with open(path, "w") as f:
            json.dump(notebook(spec), f, indent=1)
            f.write("\n")
        print("wrote", path)


if __name__ == "__main__":
    main()
