"""Helpers of the port's checkpoint tests: write HF-layout safetensors files
and compare a JAX tree with a port tree leaf by leaf."""

import json
import struct

import numpy as np
import torch

NAMES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
         torch.int8: "I8", torch.int32: "I32"}


def write_safetensors(path, tensors):
    """Write {name: tensor} (numpy arrays or torch tensors on any device) as
    one .safetensors file: a little-endian u64 header length, the JSON
    header padded to 8 bytes with spaces, then each tensor's bytes in
    order."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray) else t
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + raw.nbytes]}
        blobs.append(raw)
        off += raw.nbytes
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw.tobytes())


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_trees_equal(jtree, ttree, near=()):
    """Every leaf of the port's tree bit-identical to the JAX tree's (same
    keys, shapes and dtypes); the leaves named in `near` (the RoPE tables,
    whose f32 cos and sin XLA's CPU and torch approximate differently)
    within one f32 ulp."""
    jl, tl = dict(leaves(jtree)), dict(leaves(ttree))
    assert jl.keys() == tl.keys(), set(jl) ^ set(tl)
    for name, a in jl.items():
        a, t = np.asarray(a), tl[name]
        assert tuple(t.shape) == a.shape, (name, t.shape, a.shape)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            assert np.array_equal(a.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16)), name
            continue
        assert str(t.dtype).split(".")[1] == str(a.dtype), (name, t.dtype, a.dtype)
        if name in near:
            assert np.all(np.abs(t.numpy() - a) <= np.spacing(np.abs(a))), name
        else:
            assert np.array_equal(a, t.numpy()), name
