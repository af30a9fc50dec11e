"""The PyTorch port imports neither JAX nor the JAX package."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "simple_vae_rs_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_imports_no_jax():
    mods = _port_modules()
    assert len(mods) >= 15
    for mod in ("fused_conv", "fused_elbo", "fused_int8", "quantize", "attention", "sequences",
                "tiling"):
        assert f"simple_vae_rs_tpu_torch.ops.{mod}" in mods
    assert "simple_vae_rs_tpu_torch.parallel.mesh" in mods
    for mod in ("tiling", "raster", "wire", "batching", "server", "client", "make_index",
                "convert_checkpoint", "export"):
        assert f"simple_vae_rs_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'simple_vae_rs_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_import():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                words = stripped.replace(",", " ").split()
                roots = {w.split(".")[0] for w in words[1:] if w not in ("import", "as")}
                assert not roots & {"jax", "flax", "simple_vae_rs_tpu"}, f"{path}: {line}"
