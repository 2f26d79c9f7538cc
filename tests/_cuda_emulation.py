"""Run a kernel source of ``citylearn_tpu_torch/csrc`` on the CPU.

``build(name)`` compiles ``csrc/<name>.cu`` with ``g++`` against the stub
runtime of ``tests/_cuda_emulation_include`` (a block's threads as
``std::thread``s, barriers and shuffles by ``std::barrier``, ``cp.async``
as a plain copy) after two textual rewrites: a dynamic shared array
becomes a pointer into a host buffer and each ``kernel<<<grid, block,
shared, stream>>>(args)`` a call of ``emu_launch``. Built with
``-ffp-contract=off``, every float operation rounds as the card's IEEE
operations do. ``wrapper(module, name, lib)`` re-defines the module's
public wrapper so that its CUDA branch, checks and allocation included,
runs on CPU tensors through ``lib``. ``ieee_sqrt(monkeypatch)`` makes the
plain versions' ``torch.sqrt`` correctly rounded: PyTorch's float32 square
root on an AVX-512 CPU can miss it by an ulp, the card's never does.
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import re
import subprocess
import textwrap
from pathlib import Path

import torch

INCLUDE = Path(__file__).resolve().parent / "_cuda_emulation_include"
CSRC = Path(__file__).resolve().parents[1] / "citylearn_tpu_torch" / "csrc"


def build(name: str, out_dir: Path, defines=()) -> ctypes.CDLL:
    text = (CSRC / f"{name}.cu").read_text()
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_shared.data());", text)
    text, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\1, \2, \3);", text,
                      flags=re.S)
    assert n > 0, f"no launch found in csrc/{name}.cu"
    source = Path(out_dir) / f"{name}.cpp"
    source.write_text(f'#line 1 "{CSRC / name}.cu"\n' + text)
    lib = source.with_suffix(".so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-pthread", "-w", f"-I{INCLUDE}", f"-I{CSRC}",
                    *(f"-D{d}" for d in defines), "-o", str(lib), str(source)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def wrapper(module, name: str, lib: ctypes.CDLL):
    """``module.<name>`` with its CUDA branch taken on CPU tensors and its
    launcher read from ``lib``."""
    shipped = inspect.getsource(module._launcher)
    argtypes = eval(re.search(r"fn\.argtypes = (.*?)\n\s*fn\.restype", shipped, re.S).group(1),
                    vars(module))
    fn = getattr(lib, re.search(r"\.(\w+_launch)\b", shipped).group(1))
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    src = textwrap.dedent(inspect.getsource(getattr(module, name)))
    for old, new in (('.device.type == "cpu"', '.device.type == "emulated"'),
                     ('.device.type != "cuda"', '.device.type == "emulated"'),
                     ("_launcher()", "_emulated_launcher")):
        assert old in src, old
        src = src.replace(old, new)
    src, n = re.subn(r"torch\.cuda\.current_stream\(\w+\.device\)\.cuda_stream", "None", src)
    assert n == 1, "the wrapper names no stream"
    # the launch runs under its tensors' card; the emulation has none
    src, n = re.subn(r"torch\.cuda\.device\(\w+(\.device)?\)", "contextlib.nullcontext()", src)
    assert n == 1, "the wrapper launches under no device"
    namespace = dict(vars(module), _emulated_launcher=fn, contextlib=contextlib)
    exec(compile(src, f"<emulated {name}>", "exec"), namespace)
    emulated = namespace[name]
    emulated.launches = 0
    return emulated


def ieee_sqrt(monkeypatch):
    real = torch.sqrt

    def sqrt(x, *args, **kwargs):
        if x.dtype == torch.float32:        # float64's root rounds to float32's exactly
            return real(x.double(), *args, **kwargs).to(torch.float32)
        return real(x, *args, **kwargs)

    monkeypatch.setattr(torch, "sqrt", sqrt)
