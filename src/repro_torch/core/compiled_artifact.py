"""Standalone compiled-network artifacts — the paper's C++ codegen analogue.

The paper 'compiles' the trained CNN into a C++ program with the weights
baked in as constants, deployable as a single binary. The port's
equivalent: close over the weights so that ``torch.export`` lifts them as
constants of the program, export one ATen program per supported batch size
(the generated C++ ran fixed-shape loops too), and write all of them, with
``torch.export.save``, into one blob that runs WITHOUT the model's Python
code — a single deployable file.

  MAGIC | u64 header_len | JSON header | the entries' saved bytes, by key

Header: {"meta", "device", "entries": {key: nbytes}}. The magic is the
port's own: the JAX package's ``RPROHLO1`` blobs hold StableHLO, which does
not run in torch, and are refused by name. The weights cross between the
packages through the ``RPROAVRO1`` export instead. A blob runs only on the
device type it was built for (its constants live there).

A loaded program runs its ATen graph op by op, as exported: loading and
calling compile nothing.
"""
from __future__ import annotations

import io
import json
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device

MAGIC = b"RPROPT2A1\n"
JAX_MAGIC = b"RPROHLO1\n"


class _Program(torch.nn.Module):
    """``torch.export`` takes a module: this one calls ``fn``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def build_artifact(fn: Callable, example_args_per_shape: Dict[str, Tuple],
                   meta: Dict | None = None) -> bytes:
    """fn: already closed over its weights (constants, not inputs).
    example_args_per_shape maps a shape-key (e.g. "b64") to a tuple of
    example tensors, all on the device the artifact is built for."""
    from torch import export as torch_export
    entries, devices = {}, set()
    for key, args in example_args_per_shape.items():
        devices |= {a.device.type for a in args}
        exported = torch_export.export(_Program(fn), tuple(args))
        buf = io.BytesIO()
        torch_export.save(exported, buf)
        entries[key] = buf.getvalue()
    if len(devices) != 1:
        raise ValueError(f"an artifact is built for one device type; the "
                         f"example arguments lie on {sorted(devices)}")
    header = json.dumps({"meta": meta or {}, "device": devices.pop(),
                         "entries": {k: len(v) for k, v in entries.items()}}
                        ).encode()
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(len(header).to_bytes(8, "little"))
    out.write(header)
    for k in sorted(entries):
        out.write(entries[k])
    return out.getvalue()


class CompiledArtifact:
    """Runs a serialized network with zero access to the defining code."""

    def __init__(self, entries: Dict[str, Callable], meta: Dict, device: str):
        self._entries = entries
        self.meta = meta
        self.device = device

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "CompiledArtifact":
        """Load every entry of ``data`` for ``device`` (the card unless the
        caller asks for the CPU); a blob built for another device type, a
        JAX ``RPROHLO1`` blob or any other bytes raise ``ValueError``."""
        from torch import export as torch_export
        if data.startswith(JAX_MAGIC):
            raise ValueError(
                "a JAX compiled artifact (RPROHLO1, StableHLO) does not run "
                "in the port; export the weights as RPROAVRO1 and build the "
                "artifact with the port")
        if not data.startswith(MAGIC):
            raise ValueError("bad magic: not a compiled artifact")
        dev = resolve_device(device)
        hlen = int.from_bytes(data[len(MAGIC):len(MAGIC) + 8], "little")
        hstart = len(MAGIC) + 8
        header = json.loads(data[hstart:hstart + hlen])
        if header["device"] != dev.type:
            raise ValueError(f"artifact built for device {header['device']!r} "
                             f"cannot run on {dev.type!r}")
        body = hstart + hlen
        entries = {}
        for k in sorted(header["entries"]):
            n = header["entries"][k]
            program = torch_export.load(io.BytesIO(data[body:body + n]))
            entries[k] = program.module()
            body += n
        return cls(entries, header["meta"], header["device"])

    @classmethod
    def from_file(cls, path: str, device="cuda") -> "CompiledArtifact":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read(), device)

    @property
    def shape_keys(self) -> Sequence[str]:
        return sorted(self._entries)

    def call(self, key: str, *args):
        return self._entries[key](*args)
