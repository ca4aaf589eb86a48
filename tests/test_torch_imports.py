"""The port stands alone: no file of tac_torch/ or chip_smoke.py imports jax
or any module of the tac package, and tac_torch imports and runs in a
process where both are blocked."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tac_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_no_jax_or_tac_imports_in_the_port():
    bad = []
    files = _port_files()
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "tac")]
    assert not bad, bad


def test_port_imports_and_encodes_with_jax_and_tac_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'tac'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import tac_torch, tac_torch.codec, tac_torch.ops.alloc, "
        "tac_torch.ops.pack, tac_torch.ops.vbr_scan, tac_torch.ops.huffdec, "
        "tac_torch.ops.mdct_fused, tac_torch.blockswitch, tac_torch.filterbank, "
        "tac_torch.huffman, tac_torch._build, tac_torch.streaming, "
        "tac_torch.io.wav, tac_torch.parallel, tac_torch.corpus, "
        "tac_torch.cli, tac_torch.tuning\n"
        "for preset in ('stereo44-128', 'vbr-huffman', 'vbr-bs', 'vbr-ms-bs'):\n"
        "    data = tac_torch.encode_array(np.zeros((3000, 2)), "
        "tac_torch.PRESETS[preset], device='cpu')\n"
        "    y, fs = tac_torch.decode_array(data, device='cpu')\n"
        "    assert y.shape == (3000, 2) and fs == 44100\n"
        "enc = tac_torch.StreamEncoder(tac_torch.PRESETS['vbr-ms-bs'], "
        "device='cpu')\n"
        "data = enc.header(3000) + enc.push(np.zeros((3000, 2))) + enc.flush()\n"
        "assert data == tac_torch.encode_array(np.zeros((3000, 2)), "
        "tac_torch.PRESETS['vbr-ms-bs'], device='cpu')\n"
        "dec, off = tac_torch.StreamDecoder.from_header(data, device='cpu')\n"
        "assert dec.push(data[off:]).shape == (3000, 2)\n"
        "assert tac_torch.decode_range(data, 5, 50, device='cpu')[0].shape "
        "== (45, 2)\n"
        "assert not any(m.split('.')[0] in ('jax', 'tac') for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
