"""Original darknet ``.weights`` import and export for ``DarknetBackbone``
(counterpart of ``keras_object_detection_tpu/models/darknet_import.py``).

Format (darknet ``src/parser.c`` ``save_weights_upto`` /
``load_weights_upto``): int32 major, minor, revision, then ``seen`` as int64
when ``major * 10 + minor >= 2`` (else int32); then per conv layer in
network order beta[n], gamma[n], rolling_mean[n], rolling_var[n] and the
weights[n * c * k * k] in ``(out, in, kh, kw)`` order, the port's own
layout; little-endian float32.

Two differences are folded exactly, in the JAX package's numpy arithmetic:
- BN epsilon: darknet normalises with 1e-5, the port with 1e-3. Loading
  scales gamma by ``sqrt((var + 1e-3) / (var + 1e-5))``; saving inverts it.
- Conv bias: darknet's BN convs have none, the port's do. Loading zeroes
  it; saving folds it into the rolling mean (``mean - bias``).

A ``.conv.NN`` file (a backbone prefix) loads the first NN convs and leaves
the rest as they were; ``strict=True`` demands the whole backbone.
"""

from __future__ import annotations

import re
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

HEADER_MAJOR, HEADER_MINOR, HEADER_REVISION = 0, 2, 0


def _blocks(state_dict: Mapping[str, torch.Tensor]) -> list:
    """``backbone.blocks.<i>`` prefixes of the conv blocks, in network
    order."""
    found = set()
    for k in state_dict:
        m = re.fullmatch(r"(backbone\.blocks\.(\d+))\.conv\.weight", k)
        if m:
            found.add((int(m.group(2)), m.group(1)))
    if not found:
        raise ValueError("the state dict has no darknet backbone conv blocks")
    return [name for _, name in sorted(found)]


def load_darknet_backbone(
    state_dict: Mapping[str, torch.Tensor],
    weights_path: str,
    *,
    strict: bool = False,
    bn_eps: float = 1e-3,
    darknet_eps: float = 1e-5,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A copy of ``state_dict`` with the darknet file's convs loaded into
    its backbone blocks, and an info dict (``loaded_convs``,
    ``total_convs``, ``seen``, ``leftover_bytes``, ``version``)."""
    with open(weights_path, "rb") as f:
        buf = f.read()
    if len(buf) < 12:
        raise ValueError(f"{weights_path}: too short for a darknet header")
    major, minor, revision = struct.unpack_from("<3i", buf, 0)
    if not (0 <= major <= 1000 and 0 <= minor <= 1000):
        raise ValueError(f"{weights_path}: implausible header version "
                         f"{major}.{minor}; not a darknet weights file?")
    if major * 10 + minor >= 2:
        (seen,) = struct.unpack_from("<q", buf, 12)
        off = 20
    else:
        (seen,) = struct.unpack_from("<i", buf, 12)
        off = 16

    def floats(n: int) -> np.ndarray:
        nonlocal off
        out = np.frombuffer(buf, dtype="<f4", count=n, offset=off).copy()
        off += 4 * n
        return out

    out = dict(state_dict)
    blocks = _blocks(state_dict)
    loaded = 0
    for blk in blocks:
        cout, cin, kh, kw = state_dict[f"{blk}.conv.weight"].shape
        need = 4 * cout + kh * kw * cin * cout
        remaining = len(buf) - off
        if remaining < 4 * need:
            if strict:
                raise EOFError(f"{weights_path}: file ends inside or before "
                               f"{blk} (loaded {loaded}/{len(blocks)} convs)")
            if remaining:
                raise ValueError(f"{weights_path}: {remaining} trailing bytes "
                                 f"do not align with {blk}'s {4 * need}-byte "
                                 "record; architecture mismatch?")
            break
        beta, gamma, mean, var = (floats(cout) for _ in range(4))
        w = floats(kh * kw * cin * cout).reshape(cout, cin, kh, kw)
        # exact eps fold: scale / sqrt(var + ours) == gamma / sqrt(var + theirs)
        gamma = gamma * np.sqrt((var + bn_eps) / (var + darknet_eps))
        out.update({
            f"{blk}.conv.weight": torch.from_numpy(w),
            f"{blk}.conv.bias": torch.zeros(cout),
            f"{blk}.bn.weight": torch.from_numpy(gamma),
            f"{blk}.bn.bias": torch.from_numpy(beta),
            f"{blk}.bn.running_mean": torch.from_numpy(mean),
            f"{blk}.bn.running_var": torch.from_numpy(var)})
        loaded += 1
    leftover = len(buf) - off
    if leftover and loaded == len(blocks):
        raise ValueError(f"{weights_path}: {leftover} bytes remain after all "
                         f"{len(blocks)} backbone convs; the file holds a "
                         "bigger network, expected a backbone prefix "
                         "(.conv.NN) file")
    info = {"loaded_convs": loaded, "total_convs": len(blocks),
            "seen": int(seen), "leftover_bytes": leftover,
            "version": f"{major}.{minor}.{revision}"}
    return out, info


def save_darknet_backbone(
    state_dict: Mapping[str, torch.Tensor],
    weights_path: str,
    *,
    num_convs: Optional[int] = None,
    seen: int = 0,
    bn_eps: float = 1e-3,
    darknet_eps: float = 1e-5,
) -> Dict[str, Any]:
    """Write the backbone (or its first ``num_convs`` convs, darknet's
    ``.conv.NN`` convention) as a darknet ``.weights`` file, with the conv
    bias folded into the rolling mean and the epsilon rescale inverted, so
    that save -> load gives the same eval-mode function."""
    blocks = _blocks(state_dict)
    if num_convs is not None:
        blocks = blocks[:num_convs]
    arr = lambda k: state_dict[k].detach().cpu().numpy().astype(np.float32)  # noqa: E731
    out = [struct.pack("<3iq", HEADER_MAJOR, HEADER_MINOR, HEADER_REVISION,
                       seen)]
    for blk in blocks:
        gamma, beta = arr(f"{blk}.bn.weight"), arr(f"{blk}.bn.bias")
        mean, var = arr(f"{blk}.bn.running_mean"), arr(f"{blk}.bn.running_var")
        gamma = gamma * np.sqrt((var + darknet_eps) / (var + bn_eps))
        mean = mean - arr(f"{blk}.conv.bias")
        out += [beta.tobytes(), gamma.tobytes(), mean.tobytes(), var.tobytes(),
                np.ascontiguousarray(arr(f"{blk}.conv.weight")).tobytes()]
    with open(weights_path, "wb") as f:
        f.write(b"".join(out))
    return {"saved_convs": len(blocks), "bytes": sum(len(b) for b in out)}
