"""tflite -> weights importer (counterpart of the JAX package's
``models/tflite_import.py``).

The reference shipped its weights as tflite FlatBuffers.  This module walks
a tflite file's conv-type ops (``CONV_2D``, ``DEPTHWISE_CONV_2D``,
``FULLY_CONNECTED``) in graph order, dequantizes their weights
(``scale * (x - zero_point)``) and maps them by order and shape onto the
flat Flax-named tree that ``core/weights.py carry_across`` reads, which then
carries them into the port's model.

The card's machine has neither TensorFlow nor ``flatbuffers``, so the file
is read here with ``struct`` and numpy: :class:`_Table` reads a FlatBuffer
table, and the fields of TFLite's ``schema.fbs`` that the importer needs
are named by their schema index below.  A field a writer left out (a
vtable cut short, or a zero offset) takes the schema's default.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct

import numpy as np

# TFLite schema.fbs field indices (the vtable slot of each field)
MODEL_OPERATOR_CODES, MODEL_SUBGRAPHS, MODEL_BUFFERS = 1, 2, 4
OPCODE_DEPRECATED_BUILTIN_CODE, OPCODE_BUILTIN_CODE = 0, 3
SUBGRAPH_TENSORS, SUBGRAPH_OPERATORS = 0, 3
TENSOR_SHAPE, TENSOR_TYPE, TENSOR_BUFFER, TENSOR_QUANTIZATION = 0, 1, 2, 4
QUANT_SCALE, QUANT_ZERO_POINT, QUANT_QUANTIZED_DIMENSION = 2, 3, 6
BUFFER_DATA, BUFFER_OFFSET, BUFFER_SIZE = 0, 1, 2
OPERATOR_OPCODE_INDEX, OPERATOR_INPUTS = 0, 1

# BuiltinOperator codes of the ops that carry conv weights
CONV_OPS = {3: "CONV_2D", 4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED"}
# TensorType -> numpy dtype (little-endian, as FlatBuffers store them)
TENSOR_TYPES = {0: "<f4", 1: "<f2", 2: "<i4", 3: "u1", 4: "<i8", 6: "?", 7: "<i2", 9: "i1",
                10: "<f8", 12: "<u8", 15: "<u4", 16: "<u2"}
TENSOR_TYPE_NAMES = {5: "STRING", 8: "COMPLEX64", 11: "COMPLEX128", 13: "RESOURCE",
                     14: "VARIANT", 17: "INT4", 18: "BFLOAT16"}


class _Table:
    """One FlatBuffer table of ``buf`` at offset ``pos``."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vtable)[0]

    def _field(self, index: int) -> int:
        """The field's offset inside the table, 0 when absent."""
        slot = 4 + 2 * index
        if slot + 2 > self.vt_size:
            return 0
        return struct.unpack_from("<H", self.buf, self.vtable + slot)[0]

    def scalar(self, index: int, fmt: str, default):
        off = self._field(index)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def _target(self, index: int) -> int | None:
        off = self._field(index)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, index: int) -> "_Table | None":
        at = self._target(index)
        return None if at is None else _Table(self.buf, at)

    def vector(self, index: int, dtype: str) -> np.ndarray:
        """A vector of scalars (empty when absent)."""
        at = self._target(index)
        if at is None:
            return np.zeros(0, dtype)
        n = struct.unpack_from("<I", self.buf, at)[0]
        return np.frombuffer(self.buf, dtype, n, at + 4)

    def tables(self, index: int) -> list["_Table"]:
        """A vector of tables (empty when absent)."""
        at = self._target(index)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for i in range(n):
            el = at + 4 + 4 * i
            out.append(_Table(self.buf, el + struct.unpack_from("<I", self.buf, el)[0]))
        return out


def _read_tensor(t: _Table, buffers: list[_Table]) -> tuple[np.ndarray, dict]:
    """A constant tensor's values and its quantization parameters, as
    TensorFlow's interpreter reports them (scales f32, zero points i32)."""
    ttype = t.scalar(TENSOR_TYPE, "b", 0)
    if ttype not in TENSOR_TYPES:
        name = TENSOR_TYPE_NAMES.get(ttype, f"type {ttype}")
        raise ValueError(f"tflite tensor of type {name} is not read")
    shape = tuple(int(d) for d in t.vector(TENSOR_SHAPE, "<i4"))
    buf = buffers[t.scalar(TENSOR_BUFFER, "I", 0)]
    if buf.scalar(BUFFER_OFFSET, "Q", 0) or buf.scalar(BUFFER_SIZE, "Q", 0):
        raise ValueError("tflite buffer in the offset/size form (data outside the "
                         "FlatBuffer) is not read")
    data = buf.vector(BUFFER_DATA, "u1")
    arr = np.frombuffer(data.tobytes(), TENSOR_TYPES[ttype]).reshape(shape)
    arr = arr.astype(arr.dtype.newbyteorder("="))
    q = t.table(TENSOR_QUANTIZATION)
    quant = {"scales": np.zeros(0, np.float32), "zero_points": np.zeros(0, np.int32),
             "quantized_dimension": 0}
    if q is not None:
        quant = {"scales": q.vector(QUANT_SCALE, "<f4").astype(np.float32),
                 "zero_points": q.vector(QUANT_ZERO_POINT, "<i8").astype(np.int32),
                 "quantized_dimension": q.scalar(QUANT_QUANTIZED_DIMENSION, "i", 0)}
    return arr, quant


@dataclasses.dataclass
class ConvWeights:
    """One conv-type op's dequantized parameters, in graph (execution) order."""

    op_index: int
    op_name: str  # "CONV_2D" | "DEPTHWISE_CONV_2D" | "FULLY_CONNECTED"
    kernel: np.ndarray  # HWIO (tflite OHWI / depthwise 1HWO transposed); FC (I, O)
    bias: np.ndarray | None  # (O,), None if the op has no bias input


def _dequant(arr: np.ndarray, quant: dict) -> np.ndarray:
    """Affine dequantize, ``scale * (x - zero_point)``, in the JAX package's
    numpy types (an integer tensor comes back float64)."""
    scales = np.asarray(quant.get("scales", ()))
    if arr.dtype in (np.float32, np.float64) or scales.size == 0:
        return np.asarray(arr, np.float32)
    zero_points = np.asarray(quant.get("zero_points", np.zeros_like(scales)))
    axis = int(quant.get("quantized_dimension", 0))
    shape = [1] * arr.ndim
    if scales.size > 1:
        shape[axis] = scales.size
    return (arr.astype(np.float32) - zero_points.reshape(shape)) * scales.reshape(shape)


def read_conv_weights(path) -> list[ConvWeights]:
    """Every conv-type op's weights from a tflite file, in graph order (the
    first subgraph's operators)."""
    buf = pathlib.Path(path).read_bytes()
    if len(buf) < 8:
        raise ValueError(f"{path} is too short for a tflite FlatBuffer")
    model = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    codes = [max(c.scalar(OPCODE_DEPRECATED_BUILTIN_CODE, "b", 0),
                 c.scalar(OPCODE_BUILTIN_CODE, "i", 0))
             for c in model.tables(MODEL_OPERATOR_CODES)]
    buffers = model.tables(MODEL_BUFFERS)
    subgraphs = model.tables(MODEL_SUBGRAPHS)
    if not subgraphs:
        raise ValueError(f"{path} has no subgraph")
    tensors = subgraphs[0].tables(SUBGRAPH_TENSORS)
    out: list[ConvWeights] = []
    for i, op in enumerate(subgraphs[0].tables(SUBGRAPH_OPERATORS)):
        name = CONV_OPS.get(codes[op.scalar(OPERATOR_OPCODE_INDEX, "I", 0)])
        if name is None:
            continue
        inputs = [int(t) for t in op.vector(OPERATOR_INPUTS, "<i4") if t >= 0]
        if len(inputs) < 2:
            continue
        kernel = _dequant(*_read_tensor(tensors[inputs[1]], buffers))
        bias = None
        if len(inputs) >= 3:
            bias = _dequant(*_read_tensor(tensors[inputs[2]], buffers))
        if name == "CONV_2D":
            kernel = np.transpose(kernel, (1, 2, 3, 0))  # OHWI -> HWIO
        elif name == "DEPTHWISE_CONV_2D":
            # (1, H, W, C), the channel last -> the grouped conv's HWIO (H, W, 1, C)
            _, h, w, c = kernel.shape
            kernel = kernel.reshape(h, w, c)[:, :, None, :]
        else:  # FULLY_CONNECTED (O, I) -> (I, O)
            kernel = kernel.T
        out.append(ConvWeights(op_index=i, op_name=name, kernel=kernel, bias=bias))
    return out


def _conv_sites(tree: dict) -> list[str]:
    """The conv sites of a flat tree (``params/<site>/kernel`` keys), in the
    tree's order."""
    return [k[len("params/"):-len("/kernel")] for k in tree
            if k.startswith("params/") and k.endswith("/kernel")]


def conv_order_from_model(model) -> list[str]:
    """The Flax paths of a port model's conv sites in module definition
    order, which is the JAX model's (its state dict names are the Flax
    paths with dots)."""
    return [k.rpartition(".")[0].replace(".", "/") for k, v in model.state_dict().items()
            if k.rpartition(".")[2] in ("weight", "kernel_q") and v.ndim == 4]


def map_convs_to_params(convs: list[ConvWeights], tree: dict,
                        order: list[str] | None = None) -> tuple[dict, dict]:
    """Assign imported conv weights onto a flat tree by order and exact shape.

    Greedy in order: each imported conv claims the first remaining site at
    or after the last claimed one whose kernel shape matches.  A bias goes
    to the site's own ``bias``, or else (a ConvBN site, whose tflite graph
    folded its BatchNorm into the conv) is added to the sibling
    ``BatchNorm_0``'s bias.  ``order`` (:func:`conv_order_from_model`)
    fixes the sites' order; without it, the tree's own.  Returns
    ``(new_tree, report)``: the report lists what was mapped, the ops that
    found no site, the sites left unfilled and the biases dropped.
    """
    tree = {k: np.asarray(v).copy() for k, v in tree.items()}
    slots = _conv_sites(tree)
    if order is not None:
        missing = [p for p in order if p not in slots]
        if missing or len(order) != len(slots):
            raise ValueError(f"order/tree mismatch: {len(order)} ordered paths vs "
                             f"{len(slots)} tree convs; missing {missing[:3]}")
        slots = list(order)
    taken = [False] * len(slots)
    mapped, unmapped, dropped_biases = [], [], []
    cursor = 0
    for cw in convs:
        hit = next((j for j in range(cursor, len(slots)) if not taken[j]
                    and tree[f"params/{slots[j]}/kernel"].shape == cw.kernel.shape), None)
        if hit is None:
            unmapped.append(f"{cw.op_name}@{cw.op_index} kernel{cw.kernel.shape}")
            continue
        name = slots[hit]
        key = f"params/{name}/kernel"
        tree[key] = cw.kernel.astype(tree[key].dtype)
        if cw.bias is not None:
            own = f"params/{name}/bias"
            parent = name.rpartition("/")[0]
            bn = f"params/{parent}/BatchNorm_0/bias" if parent else "params/BatchNorm_0/bias"
            if own in tree and tree[own].shape == cw.bias.shape:
                tree[own] = cw.bias.astype(tree[own].dtype)
            elif bn in tree and tree[bn].shape == cw.bias.shape:
                tree[bn] = (np.asarray(tree[bn], np.float32) + cw.bias).astype(np.float32)
            else:
                dropped_biases.append(name)
        taken[hit] = True
        cursor = hit + 1  # graph order: later ops map to later sites
        mapped.append(f"{cw.op_name}@{cw.op_index} → {name}")
    report = {
        "mapped": mapped,
        "unmapped_ops": unmapped,
        "unfilled_params": [slots[j] for j in range(len(slots)) if not taken[j]],
        "dropped_biases": dropped_biases,
    }
    return tree, report


def import_tflite(path, tree: dict, model=None) -> tuple[dict, dict]:
    """Read the conv weights of ``path`` and map them onto the flat tree
    ``tree``, in ``model``'s conv order when a port model is given.  The
    result goes through ``core.weights.carry_across`` into the model."""
    order = None if model is None else conv_order_from_model(model)
    return map_convs_to_params(read_conv_weights(path), tree, order=order)
