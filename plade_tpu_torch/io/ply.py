"""Host-side PLY reader/writer (numpy, with the native C++ reader).

A copy of ``plade_tpu/io/ply.py``: that package imports JAX when it is
imported, and this one must run where JAX is absent.
``tests/test_torch_core.py`` pins the copy to the original.  ``read_ply``
takes the port's own native reader (``io/native.py``) when it builds, and
the numpy reader otherwise, as the original does.

Parses ascii and binary little/big-endian PLY, merges ``x,y,z`` into points
and ``nx,ny,nz`` into normals; registration requires normals, but the
reader returns whatever is present and lets the caller decide.
"""
from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Read a PLY file.

    Returns ``(points, normals)`` as float32 arrays; ``normals`` is None when
    the file has no nx/ny/nz properties.  Uses the native C++ reader
    (plade_tpu_torch/native/ply_io.cpp) when built; falls back to pure
    numpy."""
    from . import native
    if native.available():
        try:
            return native.read_ply(path)
        except ValueError:
            pass  # fall through for formats the native reader rejects
    return _read_ply_numpy(path)


def _read_ply_numpy(path: str):
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            text = line.decode("ascii", errors="replace").strip()
            header_lines.append(text)
            if text == "end_header":
                break

        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        for text in header_lines:
            parts = text.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if not elements:
                    raise ValueError(f"{path}: property before element")
                if parts[1] == "list":
                    # list properties (e.g. face indices) — record specially
                    elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
                else:
                    elements[-1][2].append((parts[2], parts[1]))

        if fmt is None:
            raise ValueError(f"{path}: no format line")

        vertex_data = None
        for name, count, props in elements:
            if name == "vertex":
                vertex_data = _read_element(f, fmt, count, props, path)
            else:
                _skip_element(f, fmt, count, props, path)
            if vertex_data is not None:
                break  # vertex is conventionally first; stop once read

    if vertex_data is None:
        raise ValueError(f"{path}: no vertex element")

    def stack(names):
        if all(n in vertex_data for n in names):
            return np.stack([vertex_data[n].astype(np.float32) for n in names],
                            axis=1)
        return None

    points = stack(("x", "y", "z"))
    if points is None:
        raise ValueError(f"{path}: vertex element lacks x/y/z")
    normals = stack(("nx", "ny", "nz"))
    return points, normals


def _scalar_dtype(prop_type: str, fmt: str) -> np.dtype:
    base = _PLY_DTYPES[prop_type]
    if fmt == "binary_little_endian":
        return np.dtype("<" + base)
    if fmt == "binary_big_endian":
        return np.dtype(">" + base)
    return np.dtype(base)


def _read_element(f, fmt, count, props, path):
    has_list = any(isinstance(t, tuple) for _, t in props)
    if fmt == "ascii":
        if has_list:
            raise ValueError(f"{path}: ascii list properties unsupported for vertex")
        names = [n for n, _ in props]
        rows = np.loadtxt(
            [f.readline() for _ in range(count)], dtype=np.float64, ndmin=2)
        if rows.shape != (count, len(names)):
            raise ValueError(f"{path}: ascii vertex data shape mismatch")
        return {n: rows[:, i] for i, n in enumerate(names)}
    if has_list:
        raise ValueError(f"{path}: binary list properties unsupported for vertex")
    dtype = np.dtype([(n, _scalar_dtype(t, fmt)) for n, t in props])
    buf = f.read(dtype.itemsize * count)
    if len(buf) != dtype.itemsize * count:
        raise ValueError(f"{path}: truncated vertex data")
    rec = np.frombuffer(buf, dtype=dtype, count=count)
    return {n: rec[n] for n, _ in props}


def _skip_element(f, fmt, count, props, path):
    has_list = any(isinstance(t, tuple) for _, t in props)
    if fmt == "ascii":
        for _ in range(count):
            f.readline()
        return
    if not has_list:
        itemsize = sum(_scalar_dtype(t, fmt).itemsize for _, t in props)
        f.seek(itemsize * count, 1)
        return
    # binary element with list properties: walk it item by item
    for _ in range(count):
        for _, t in props:
            if isinstance(t, tuple):
                _, count_type, item_type = t
                cdt = _scalar_dtype(count_type, fmt)
                n = int(np.frombuffer(f.read(cdt.itemsize), dtype=cdt)[0])
                f.seek(_scalar_dtype(item_type, fmt).itemsize * n, 1)
            else:
                f.seek(_scalar_dtype(t, fmt).itemsize, 1)


def write_ply(path: str, points: np.ndarray, normals: np.ndarray | None = None,
              binary: bool = True):
    """Write a point cloud as PLY (binary little-endian by default)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(normals)
    data = np.concatenate(cols, axis=1).astype("<f4")
    fmt = "binary_little_endian 1.0" if binary else "ascii 1.0"
    header = (
        "ply\n"
        f"format {fmt}\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.8g")
