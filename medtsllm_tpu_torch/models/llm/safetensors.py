"""The safetensors format, read and written without the ``safetensors``
package (the card's machine has none).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``__metadata__``), then the tensors' bytes, little-endian, each at
``data_offsets`` from the end of the header. ``load_safetensors`` reads
every ``*.safetensors`` file of a snapshot directory in sorted order, as
``_load_safetensors`` of ``medtsllm_tpu/models/llm/loader.py`` does, and
strips the ``model.`` / ``transformer.`` / ``backbone.`` prefixes the same
way. It reads the dtypes that JAX's reader (``safe_open(framework=
"numpy")``) reads in the JAX package, where importing jax registers
ml_dtypes' bfloat16 with numpy: the ints, bool, F16 / F32 / F64 and BF16.
A BF16 tensor comes back as f32, exactly (a bf16 value is an f32 whose low
16 bits are zero; numpy alone has no bf16); the JAX package keeps it at
bf16 and casts it to the parameter's dtype at the restore, which gives the
same parameters. FP8 and any other dtype, which that reader refuses too,
raise, naming the tensor and its dtype.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# safetensors dtype -> numpy (little-endian)
DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
          "I16": "<i2", "I8": "i1", "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1",
          "BOOL": "?"}
NAMES = {np.dtype(v): k for k, v in DTYPES.items()}
PREFIXES = ("model.", "transformer.", "backbone.")


def read_file(path: Path) -> dict[str, np.ndarray]:
    """One ``.safetensors`` file -> {name: ndarray} (copies, in the file's
    order); raises ValueError on a malformed header or an unread dtype."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: no safetensors header")
        n = int.from_bytes(raw, "little")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable safetensors header ({e})") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the safetensors header is not a JSON object")
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info.get("dtype")
        if dtype not in DTYPES and dtype != "BF16":
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, which the reader "
                             f"does not read (supported: {sorted(DTYPES) + ['BF16']})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dt = np.dtype("<u2" if dtype == "BF16" else DTYPES[dtype])
        if end > len(data) or end - begin != dt.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} {dtype} {list(shape)} does not match "
                             f"its data_offsets {[begin, end]} ({len(data)} data bytes)")
        arr = np.frombuffer(data, dt, offset=begin,
                            count=(end - begin) // dt.itemsize).reshape(shape)
        if dtype == "BF16":  # the high half of an f32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.copy()
    return out


def strip_prefixes(name: str) -> str:
    for prefix in PREFIXES:
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name


def load_safetensors(snap: Path) -> dict[str, np.ndarray]:
    """Every ``*.safetensors`` file of ``snap`` in sorted order -> {short
    name: ndarray}; a later file's tensor of the same short name wins."""
    tensors = {}
    for f in sorted(Path(snap).glob("*.safetensors")):
        for name, arr in read_file(f).items():
            tensors[strip_prefixes(name)] = arr
    return tensors


def save_safetensors(path, tensors: dict) -> None:
    """Write {name: ndarray} as one ``.safetensors`` file (the tensors in
    the dict's order, C order, little-endian; the header padded with spaces
    to a multiple of 8 bytes, as the format's writers do)."""
    header, offset, arrays = {}, 0, []
    for name, value in tensors.items():
        arr = np.ascontiguousarray(value)
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if dt not in NAMES:
            raise ValueError(f"tensor {name!r}: dtype {arr.dtype} has no safetensors name")
        arr = arr.astype(dt, copy=False)
        header[name] = {"dtype": NAMES[dt], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())
