"""Parameter store: nested ``{layer: {param: tensor}}`` trees plus per-
parameter metadata (counterpart of ``paddle_tpu/parameters.py``).

Keys are dotted (``"layer.param"``); ``to_tar``/``from_tar`` write and read
the JAX package's tar of one ``.npy`` per key, so a tar crosses between the
packages in both directions.  The trainer updates the tensors of
``values`` in place, so a ``Parameters`` handed to ``trainer.SGD`` holds
the trained values as training goes.
"""

from __future__ import annotations

import io
import tarfile
from typing import Dict, Iterator

import numpy as np
import torch


class Parameters:
    """Named view over the parameter tree (API parity with
    python/paddle/v2/parameters.py: __getitem__, keys, to_tar/from_tar)."""

    def __init__(self, values: Dict[str, Dict[str, torch.Tensor]],
                 meta: Dict[str, Dict[str, dict]]):
        self.values = values      # {layer: {pname: tensor}}
        self.meta = meta          # {layer: {pname: {"learning_rate":..,
                                  #   "is_static":.., "l1":.., "l2":..,
                                  #   "clip":..}}}

    # -- dict-like access by dotted name ("layer.pname") ----------------
    def _split(self, key: str):
        layer, _, pname = key.rpartition(".")
        return layer, pname

    def __getitem__(self, key: str) -> np.ndarray:
        layer, pname = self._split(key)
        return self.values[layer][pname].detach().cpu().numpy()

    def __setitem__(self, key: str, value) -> None:
        """Copy ``value`` into the parameter's tensor, in place."""
        layer, pname = self._split(key)
        cur = self.values[layer][pname]
        arr = torch.as_tensor(np.asarray(value), dtype=cur.dtype)
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(cur.shape)}")
        with torch.no_grad():
            cur.copy_(arr)

    def keys(self) -> Iterator[str]:
        for layer, ps in self.values.items():
            for pname in ps:
                yield f"{layer}.{pname}"

    def __iter__(self):
        return self.keys()

    def __contains__(self, key: str) -> bool:
        layer, pname = self._split(key)
        return layer in self.values and pname in self.values[layer]

    def get_shape(self, key: str):
        layer, pname = self._split(key)
        return tuple(self.values[layer][pname].shape)

    # -- trainable/static partition --------------------------------------
    def trainable_mask(self) -> Dict[str, Dict[str, bool]]:
        return {
            layer: {p: not m.get("is_static", False)
                    for p, m in ps.items()}
            for layer, ps in self.meta.items()
        }

    # -- serialization (reference: to_tar / from_tar) -------------------
    def to_tar(self, f) -> None:
        with tarfile.open(fileobj=f, mode="w") as tar:
            for key in self.keys():
                buf = io.BytesIO()
                np.save(buf, self[key])
                data = buf.getvalue()
                info = tarfile.TarInfo(name=key.replace("/", "_") + ".npy")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))

    def from_tar(self, f) -> None:
        """Load every entry whose key this store has (others are
        skipped, as in the JAX package); a tar saved under the other
        ``fuse_conv_bn`` setting raises (``check_fuse_conv_bn_mismatch``)."""
        with tarfile.open(fileobj=f, mode="r") as tar:
            members = tar.getmembers()
            check_fuse_conv_bn_mismatch(
                self.values, (m.name[:-len(".npy")] for m in members))
            for member in members:
                key = member.name[:-len(".npy")]
                arr = np.load(io.BytesIO(tar.extractfile(member).read()))
                if key in self:
                    self[key] = arr

    @staticmethod
    def from_topology(topology, device=None) -> "Parameters":
        return topology.create_parameters(device=device)


def tree_keys(*trees) -> list:
    """The dotted ``layer.param`` keys of nested ``{layer: {param: ...}}``
    trees (a snapshot's parts, a live parameter tree)."""
    return [f"{layer}.{p}" for tree in trees for layer, ps in
            (tree or {}).items() for p in (ps if isinstance(ps, dict)
                                           else ())]


def check_fuse_conv_bn_mismatch(layers_here, ckpt_keys) -> None:
    """Raise ``ValueError`` when saved keys (``layer.param``) and a model's
    layer names disagree on ``fuse_conv_bn`` (the JAX package's
    ``Parameters._check_fuse_conv_bn_mismatch``): the fused path names a
    conv + BN pair's layer ``<name>_fused`` and the unfused one
    ``<name>_conv`` and ``<name>_bn`` (``models/resnet.py`` ``conv_bn``), so
    a mismatched load would skip every renamed entry and train those layers
    from fresh initializers.  Every route that restores parameters from a
    snapshot calls it: ``Parameters.from_tar``, ``from_numpy``,
    ``SGD.restore``, ``serve --params`` and the serving reload."""
    layers_here = set(layers_here)
    mismatched = []
    for key in ckpt_keys:
        layer = key.rpartition(".")[0]
        if layer in layers_here:
            continue
        if layer.endswith("_fused"):
            base = layer[:-len("_fused")]
            if base + "_conv" in layers_here or base + "_bn" in layers_here:
                mismatched.append((key, "fused", base))
        else:
            for suffix in ("_conv", "_bn"):
                if layer.endswith(suffix):
                    base = layer[:-len(suffix)]
                    if base + "_fused" in layers_here:
                        mismatched.append((key, "unfused", base))
    if mismatched:
        key, kind, base = mismatched[0]
        saved, loading = ("ON", "OFF") if kind == "fused" else ("OFF", "ON")
        raise ValueError(
            f"checkpoint/model fuse_conv_bn mismatch: the checkpoint holds "
            f"{kind} conv/BN parameters (e.g. {key!r}) but this model names "
            f"layer {base!r} the other way: it was saved with fuse_conv_bn "
            f"{saved} and is being loaded with it {loading} "
            f"({len(mismatched)} affected entries). Loading would silently "
            f"keep fresh initializers for those layers; rebuild the model "
            f"with the matching paddle.init(fuse_conv_bn=...) setting "
            f"instead.")


def create(topology, device=None) -> Parameters:
    """paddle.parameters.create(topology) parity: freshly initialized from
    the ``init(seed=)`` seed, on ``device`` (default: the ``device``
    option, else the card)."""
    return Parameters.from_topology(topology, device)


def from_numpy(topology, values: dict, device=None) -> Parameters:
    """A ``Parameters`` holding a numpy tree ``{layer: {param: ndarray}}``
    (e.g. the JAX package's ``Parameters.values``) as float32 tensors on
    ``device``; the tree must have exactly the topology's parameters."""
    return topology.create_parameters(device=device, values=values)


def partition(values, mask):
    """Split a param tree into (trainable, frozen) by the boolean mask tree;
    missing entries become None."""
    trainable = {l: {p: (v if mask[l][p] else None) for p, v in ps.items()}
                 for l, ps in values.items()}
    frozen = {l: {p: (None if mask[l][p] else v) for p, v in ps.items()}
              for l, ps in values.items()}
    return trainable, frozen


def merge(trainable, frozen):
    return {l: {p: (trainable[l][p] if trainable[l][p] is not None
                    else frozen[l][p])
                for p in trainable[l]}
            for l in trainable}
