"""Minimal from-scratch NIfTI-1 writer/reader, numpy + gzip only (the
port's own copy of ``cvssl_tpu/utils/nifti.py``: the same header, dtype
codes, sform and ``mtime=0`` gzip at GzipFile's default level 9, so that a
file written here is byte-identical to the JAX package's for the same
array and spacing, and each package reads the other's files).

Restores the reference's ``.nii.gz`` export contract
(``test_3D_util.py:111-124``: ``{id}_pred/img/lab.nii.gz`` spacing (1,1,1);
``test_2D_fully.py:73-81``: ``{case}_pred/img/gt.nii.gz`` spacing (1,1,10))
without SimpleITK/nibabel, which don't exist in this image. NIfTI-1 is a
348-byte little-endian header + a 4-byte extension flag + raw voxels in
x-fastest (Fortran) order; files are plain gzip streams.

Array convention matches ``sitk.GetImageFromArray``: input arrays are
(z, y, x) [or (y, x) for 2D]; ``spacing`` is (sx, sy, sz) like
``SetSpacing``. The sform affine encodes the spacing (diagonal, RAS+).
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPES = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64),
}
_CODES = {v[0]: k for k, v in _DTYPES.items()}
# read-only extras (compliant third-party writers; we never write these)
_READ_CODES = {**_CODES,
               256: np.dtype(np.int8), 512: np.dtype(np.uint16),
               768: np.dtype(np.uint32), 1024: np.dtype(np.int64),
               1280: np.dtype(np.uint64)}


def _header(shape_xyz, dtype, spacing):
    code, bitpix = _DTYPES[np.dtype(dtype)]
    ndim = len(shape_xyz)
    dim = [ndim] + list(shape_xyz) + [1] * (7 - ndim)
    pixdim = [1.0] + list(spacing[:ndim]) + [1.0] * (7 - ndim)

    h = bytearray(348)
    struct.pack_into("<i", h, 0, 348)                     # sizeof_hdr
    struct.pack_into("<8h", h, 40, *dim)                  # dim
    struct.pack_into("<h", h, 70, code)                   # datatype
    struct.pack_into("<h", h, 72, bitpix)                 # bitpix
    struct.pack_into("<8f", h, 76, *pixdim)               # pixdim
    struct.pack_into("<f", h, 108, 352.0)                 # vox_offset
    struct.pack_into("<f", h, 112, 1.0)                   # scl_slope
    struct.pack_into("<f", h, 116, 0.0)                   # scl_inter
    struct.pack_into("<h", h, 252, 0)                     # qform_code
    struct.pack_into("<h", h, 254, 1)                     # sform_code
    sx, sy, sz = (list(spacing) + [1.0, 1.0, 1.0])[:3]
    struct.pack_into("<4f", h, 280, sx, 0, 0, 0)          # srow_x
    struct.pack_into("<4f", h, 296, 0, sy, 0, 0)          # srow_y
    struct.pack_into("<4f", h, 312, 0, 0, sz, 0)          # srow_z
    h[344:348] = b"n+1\x00"                               # magic
    return bytes(h)


def save_nifti(path: str, array: np.ndarray, spacing=(1.0, 1.0, 1.0)):
    """Write ``array`` ((z, y, x) or (y, x), sitk convention) as .nii.gz
    (or plain .nii if the path doesn't end in .gz)."""
    array = np.asarray(array)
    if array.dtype not in _DTYPES:
        array = array.astype(np.float32)
    shape_xyz = tuple(reversed(array.shape))  # C-order zyx == x-fastest
    blob = (_header(shape_xyz, array.dtype, spacing)
            + b"\x00\x00\x00\x00"            # no header extensions
            + np.ascontiguousarray(array).tobytes())
    if path.endswith(".gz"):
        # mtime=0 -> byte-stable output for tests
        with gzip.GzipFile(path, "wb", mtime=0) as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


def load_nifti(path: str):
    """Read a (simple, single-file, little-endian) NIfTI-1 file written by
    :func:`save_nifti` or a compliant writer. Returns (array in sitk
    (z, y, x) order, spacing (sx, sy, sz)). Applies scl_slope/scl_inter
    rescaling when present; unsupported layouts (big-endian, exotic
    datatype codes) raise NotImplementedError with the offending value."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        if struct.unpack_from(">i", raw, 0)[0] == 348:
            raise NotImplementedError(
                f"{path}: big-endian NIfTI-1 is not supported by the "
                "built-in reader — install SimpleITK/nibabel")
        raise ValueError(f"{path}: not NIfTI-1 (sizeof_hdr={sizeof_hdr})")
    if raw[344:347] != b"n+1":
        raise NotImplementedError(
            f"{path}: only single-file (magic 'n+1') NIfTI-1 is supported, "
            f"got magic {raw[344:348]!r}")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape_xyz = dim[1:1 + ndim]
    code = struct.unpack_from("<h", raw, 70)[0]
    if code not in _READ_CODES:
        raise NotImplementedError(
            f"{path}: NIfTI datatype code {code} is not supported by the "
            "built-in reader — install SimpleITK/nibabel")
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    dtype = _READ_CODES[code]
    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    array = data.reshape(tuple(reversed(shape_xyz)))  # back to (z, y, x)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        # NIfTI-1 spec: value = slope * stored + inter (slope 0 => unscaled)
        slope = scl_slope if scl_slope != 0.0 else 1.0
        array = (array.astype(np.float32) * np.float32(slope)
                 + np.float32(scl_inter))
    spacing = tuple(pixdim[1:1 + max(ndim, 3)][:3])
    return array, spacing
