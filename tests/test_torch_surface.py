"""The port's surface covers the JAX package's: the record that the port is complete.

An AST walk of `dpm_solver_tpu/` (nothing of it is imported, so no JAX
either) checks that
- every module has a twin at the same path in `dpm_solver_tpu_torch/`;
- every public top-level name of a module (its `__all__` where it has one,
  else its non-underscore functions, classes and assignments, and in a
  package's `__init__.py` the names it imports) is bound at the top of the
  port's twin, or stands in `BY_DESIGN` with one line of reason;
- every `examples/*.py` and `examples/*.ipynb` has its twin in
  `dpm_solver_tpu_torch/examples/`.
A table entry that the port has since bound, or whose module is gone, fails
too, so the table stays exact.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "dpm_solver_tpu", ROOT / "dpm_solver_tpu_torch"

# modules of the JAX package with no twin in the port, by design
NO_TWIN = {
    "models/ncsnpp_convert.py": "Flax score_sde checkpoints into NCSN++ params: the port reads the "
                                "score_sde_pytorch state dicts directly (cli."
                                "load_score_sde_torch_checkpoint); the tests keep it as the parity "
                                "bridge",
}

_CONVERTER = "a torch -> Flax weight converter: the port loads the reference's torch state dict " \
             "as it is; the tests keep the converter as the parity bridge"
_JAX_TYPE = "a jax.Array type alias; the port's signatures take torch.Tensor"
_FLAX_INIT = "a Flax initializer; the port's modules take torch's init (models.init_random_ for " \
             "seeded random weights)"

# (module, name) -> why the port binds no such name in the twin module
BY_DESIGN = {
    ("eval/__init__.py", "frechet_distance_jax"): "the device FID on jnp; the port's is "
                                                  "eval/fid.py::frechet_distance_torch",
    ("eval/fid.py", "frechet_distance_jax"): "the device FID on jnp; the port's is "
                                             "frechet_distance_torch",
    ("eval/inception.py", "ConvBN"): "a Flax submodule of the FID InceptionV3; the port's "
                                     "FIDInceptionV3 runs the same graph on F.conv2d",
    ("eval/inception.py", "MixedA"): "a Flax submodule of the FID InceptionV3 (FIDInceptionV3)",
    ("eval/inception.py", "MixedB"): "a Flax submodule of the FID InceptionV3 (FIDInceptionV3)",
    ("eval/inception.py", "MixedC"): "a Flax submodule of the FID InceptionV3 (FIDInceptionV3)",
    ("eval/inception.py", "MixedD"): "a Flax submodule of the FID InceptionV3 (FIDInceptionV3)",
    ("eval/inception.py", "MixedE"): "a Flax submodule of the FID InceptionV3 (FIDInceptionV3)",
    ("eval/inception.py", "convert_fid_inception"): _CONVERTER,
    ("models/__init__.py", "convert_autoencoder_kl"): _CONVERTER,
    ("models/__init__.py", "convert_bert_embedder"): _CONVERTER,
    ("models/__init__.py", "params_from_reference"): "models/ncsnpp_convert.py's converter "
                                                      "(NO_TWIN)",
    ("models/discriminator.py", "convert_torch_discriminator"): _CONVERTER,
    ("models/discriminator.py", "gan_conv_init"): _FLAX_INIT,
    ("models/lpips.py", "convert_torch_lpips"): _CONVERTER,
    ("models/ncsnpp.py", "ddpm_init"): _FLAX_INIT,
    ("models/ncsnv2.py", "ncsn_conv"): "a Flax conv helper; the port's NCSNv2 holds nn.Conv2d "
                                       "modules under the reference's names",
    ("models/text_encoder.py", "convert_bert_embedder"): _CONVERTER,
    ("models/transformer.py", "Ln"): _JAX_TYPE,
    ("models/vae.py", "convert_autoencoder_kl"): _CONVERTER,
    ("models/vae.py", "convert_vq_model"): _CONVERTER,
    ("native/__init__.py", "available"): "picks the JAX readers' Python fallback; the port's "
                                         "native.library builds at first use and raises with "
                                         "g++'s output, with no fallback to choose",
    ("native/build.py", "SRC"): "one source there; the port builds three libraries "
                                "(build.LIBRARIES)",
    ("native/build.py", "ensure_built"): "the port's is build.build(name), one library a name",
    ("native/build.py", "lib_path"): "the port's build.build(name) returns the library's path",
    ("ops/__init__.py", "bias_act_xla"): "the XLA reference of fused_bias_act; the port's plain "
                                         "twin is bias_act_plain",
    ("ops/__init__.py", "fused_solver_update"): "spelled fused_update in the port",
    ("ops/attention.py", "attention_out_ref"): "spelled attention_out_plain in the port",
    ("ops/attention.py", "attention_xla"): "spelled attention_plain in the port",
    ("ops/attention.py", "flash_attention"): "a TPU-only Pallas variant (VMEM-tiled flash); the "
                                             "port's token_attention takes every sequence length",
    ("ops/attention.py", "flash_attention_t"): "a TPU-only Pallas variant (transposed flash); "
                                               "token_attention covers it",
    ("ops/attention.py", "flash_block_q"): "a TPU tile rule of a Pallas variant; the port's "
                                           "tiles are attention_plan's",
    ("ops/attention.py", "flash_t_block_k"): "a TPU tile rule; the port's is attention_plan",
    ("ops/attention.py", "flash_t_block_q"): "a TPU tile rule; the port's is attention_plan",
    ("ops/attention.py", "fused_attention"): "a TPU-only Pallas variant (fused qkv); "
                                             "token_attention reads q/k/v column slices",
    ("ops/attention.py", "fused_attention_t"): "a TPU-only Pallas variant; token_attention "
                                               "covers it",
    ("ops/attention.py", "panel_block_q"): "a TPU tile rule of the panel kernel; the port's is "
                                           "attention_plan",
    ("ops/attention.py", "panel_fits_vmem"): "a TPU VMEM gate; the H100 has no VMEM",
    ("ops/attention.py", "panel_t_block_q"): "a TPU tile rule; the port's is attention_plan",
    ("ops/conv3x3.py", "conv3x3_supported"): "a TPU dispatch gate measured on a v5e; on a CUDA "
                                             "tensor the port always runs its kernel",
    ("ops/fused_act.py", "bias_act_xla"): "spelled bias_act_plain in the port",
    ("ops/fused_update.py", "fused_solver_update"): "spelled fused_update in the port",
    ("ops/geglu.py", "geglu_supported"): "a TPU dispatch gate measured on a v5e; the port "
                                         "always runs its kernel on a CUDA tensor",
    ("ops/ln_linear.py", "ln_linear_engaged"): "a TPU dispatch gate (_SITE_WINS); the port "
                                               "always runs its kernel on a CUDA tensor",
    ("ops/ln_linear.py", "ln_linear_reference"): "spelled ln_linear_plain in the port",
    ("ops/ln_linear.py", "ln_linear_site_wins"): "a TPU win table measured on a v5e; the port "
                                                 "carries none",
    ("ops/quant.py", "QuantDense"): "a Flax module; spelled QuantLinear (nn.Linear's layout) in "
                                    "the port",
    ("ops/quant.py", "dense"): "a Flax layer factory; the port's modules pick QuantLinear or "
                               "nn.Linear by wants_dense_quant where they build the layer",
    ("schedule.py", "Array"): _JAX_TYPE,
    ("schedule.py", "ArrayLike"): _JAX_TYPE,
    ("solver/__init__.py", "jit_hoisting_constants"): "an XLA workaround (hoists constants out "
                                                      "of a traced function); the port captures "
                                                      "CUDA graphs instead",
    ("solver/sample.py", "jit_hoisting_constants"): "an XLA workaround; the port captures CUDA "
                                                    "graphs instead (GraphedSampler)",
    ("utils/convert.py", "convert_adm_unet"): _CONVERTER,
    ("utils/convert.py", "convert_ddpm_unet"): _CONVERTER,
}


def _all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return {e.value for e in node.value.elts}
    return None


def _bound(tree, imports):
    """The names bound at the top of a module: defined, and imported where
    `imports(node)` holds for the import statement."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and imports(node):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _from_the_package(node):
    """A package's re-export: an import from the package itself."""
    return isinstance(node, ast.ImportFrom) and (
        node.level > 0 or (node.module or "").split(".")[0] == "dpm_solver_tpu")


def public_names(path: Path):
    """The JAX module's public top-level names (see the module docstring)."""
    tree = ast.parse(path.read_text(), str(path))
    names = _all(tree)
    if names is None:
        names = _bound(tree, _from_the_package if path.name == "__init__.py"
                       else lambda node: False)
    return {n for n in names if not n.startswith("_")}


def port_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    return _bound(tree, lambda node: True) | (_all(tree) or set())


JAX_MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_module_has_a_twin(rel):
    if rel in NO_TWIN:
        assert not (PORT / rel).exists(), f"{rel} has a twin now: take it out of NO_TWIN"
    else:
        assert (PORT / rel).exists(), f"the port lacks {rel}"


@pytest.mark.parametrize("rel", [r for r in JAX_MODULES if r not in NO_TWIN])
def test_every_public_name_is_ported_or_tabled(rel):
    have = port_names(PORT / rel)
    for name in sorted(public_names(JAX / rel)):
        why = BY_DESIGN.get((rel, name))
        if why is None:
            assert name in have, f"{rel}: the port binds no {name!r} and BY_DESIGN has no reason"
        else:
            assert name not in have, f"{rel}: the port binds {name!r}: take it out of BY_DESIGN"


def test_the_table_names_only_what_the_jax_package_has():
    for (rel, name), why in BY_DESIGN.items():
        assert (JAX / rel).exists() and name in public_names(JAX / rel), (rel, name)
        assert why.strip() and "\n" not in why, (rel, name)
    for rel, why in NO_TWIN.items():
        assert (JAX / rel).exists() and why.strip(), rel


@pytest.mark.parametrize("path", sorted((ROOT / "examples").glob("*.py"))
                         + sorted((ROOT / "examples").glob("*.ipynb")),
                         ids=lambda p: p.name)
def test_every_example_has_a_twin(path):
    assert (PORT / "examples" / path.name).exists(), f"the port lacks examples/{path.name}"
