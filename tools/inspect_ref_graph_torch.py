"""Read the reference's training hyperparameters from its trained
MetaGraphDef (the counterpart of ``tools/inspect_ref_graph.py``, with the
port's protobuf scanner ``rfnet_tpu_torch.compat.tf_bundle._pb_scan``).

    python tools/inspect_ref_graph_torch.py <bestrecord>/model-229999.meta

The reference's checkout ships ``bestrecord/model-229999.meta``, the whole
TF1 graph of the run behind BASELINE.md's numbers; this repository does not
hold it. The tool walks the graph and prints, from the artifact rather than
the source: the learning-rate schedule (``alpha_op``'s piecewise case
values and boundaries), the decline-factor penalty's (``alpha_op_1``), the
Adam constants, the loss expression tree from the gradient root with its
constant weights, and an op census (ApplyAdam count = the variables that
take gradients). Its output is the JAX tool's, line for line. Imports no
JAX; runs on the CPU.
"""

import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfnet_tpu_torch.compat.tf_bundle import _pb_scan  # noqa: E402


def load_nodes(meta_path):
    with open(meta_path, "rb") as f:
        data = f.read()
    graph = next(v for f_, _w, v in _pb_scan(data) if f_ == 2)  # graph_def
    nodes = {}
    for f_, _w, v in _pb_scan(graph):
        if f_ != 1:  # NodeDef
            continue
        name = op = None
        inputs = []
        tensor = None
        for f2, _w2, v2 in _pb_scan(v):
            if f2 == 1:
                name = v2.decode()
            elif f2 == 2:
                op = v2.decode()
            elif f2 == 3:
                inputs.append(v2.decode())
            elif f2 == 5:  # attr map entry
                key = av = None
                for f3, _w3, v3 in _pb_scan(v2):
                    if f3 == 1:
                        key = v3.decode()
                    elif f3 == 2:
                        av = v3
                if key == "value" and av is not None:
                    for f4, _w4, v4 in _pb_scan(av):
                        if f4 == 8:  # AttrValue.tensor
                            tensor = v4
        nodes[name] = (op, inputs, tensor)
    return nodes


def const_val(nodes, name):
    """Scalar/short-vector Const value (TensorProto: float_val=5 packed or
    fixed32, int_val=7 packed varints, tensor_content=4)."""
    name = name.split(":")[0].lstrip("^")
    op, _, t = nodes.get(name, (None, [], None))
    if op != "Const" or t is None:
        return None
    dtype = None
    content = b""
    vals = []
    for f5, w5, v5 in _pb_scan(t):
        if f5 == 1:
            dtype = v5
        elif f5 == 4:
            content = v5
        elif f5 == 5:
            if w5 == 5:
                vals.append(struct.unpack("<f", struct.pack("<I", v5))[0])
            else:
                content, dtype = v5, dtype or 1
        elif f5 == 7:
            if w5 == 0:
                vals.append(v5)
            else:  # packed varints
                p = 0
                while p < len(v5):
                    x = s = 0
                    while True:
                        b = v5[p]
                        p += 1
                        x |= (b & 0x7F) << s
                        if not b & 0x80:
                            break
                        s += 7
                    vals.append(x)
    if not vals and content:
        if dtype == 1 and len(content) >= 4:
            vals = [struct.unpack("<f", content[:4])[0]]
        elif dtype == 3 and len(content) >= 4:
            vals = [struct.unpack("<i", content[:4])[0]]
        elif dtype == 9 and len(content) >= 8:
            vals = [struct.unpack("<q", content[:8])[0]]
    if not vals:
        return None
    return vals[0] if len(vals) == 1 else vals


def dump_case_schedule(nodes, scope):
    """alpha_op-style tf.case piecewise schedule: int boundary consts
    (compared against the global step) and float value consts."""
    bounds, values = [], []
    for name, (op, _inp, _t) in sorted(nodes.items()):
        if not name.startswith(scope + "/Const"):
            continue
        suffix = name[len(scope) + 1 :]
        if "/" in suffix:
            continue
        v = const_val(nodes, name)
        if isinstance(v, int):
            bounds.append(v)
        elif isinstance(v, float):
            values.append(v)
    return sorted(bounds), values


def walk_loss(nodes, name, depth=0, lines=None):
    lines = lines if lines is not None else []
    name = name.split(":")[0]
    op, inputs, _ = nodes.get(name, ("?", [], None))
    cv = const_val(nodes, name)
    tag = f" = {cv:.6g}" if isinstance(cv, float) else ""
    lines.append("  " * depth + f"{name} [{op}]{tag}")
    if op in ("Add", "AddV2", "Mul", "Sub") and depth < 8:
        for i in inputs:
            walk_loss(nodes, i, depth + 1, lines)
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: inspect_ref_graph_torch.py <path to model-229999.meta>")
    meta = argv[0]
    if not os.path.exists(meta):
        sys.exit(f"meta graph not found: {meta}")
    nodes = load_nodes(meta)

    ops = {}
    for _n, (op, _i, _t) in nodes.items():
        ops[op] = ops.get(op, 0) + 1
    print(f"nodes: {len(nodes)}; ApplyAdam: {ops.get('ApplyAdam', 0)}; "
          f"Conv2D: {ops.get('Conv2D', 0)}; VariableV2: {ops.get('VariableV2', 0)}")

    for scope, label in (("alpha_op", "learning rate"),
                         ("alpha_op_1", "decfactor penalty weight")):
        bounds, values = dump_case_schedule(nodes, scope)
        print(f"{label}: values {values} at boundaries {bounds} "
              "(tf.case with LessEqual -> boundary-inclusive)")

    for c in ("Adam/beta1", "Adam/beta2", "Adam/epsilon"):
        print(f"{c} = {const_val(nodes, c)}")

    # gradient root: the Fill feeding the first backprop Sum names the loss
    fill_consumers = [
        n for n, (_op, inputs, _t) in nodes.items()
        if any(i.split(":")[0] == "gradients/Fill" for i in inputs)
    ]
    if fill_consumers:
        # gradients/<loss>_grad/Sum -> loss node name
        loss = fill_consumers[0].split("/")[1].rsplit("_grad", 1)[0]
        print(f"loss root: {loss}")
        print("\n".join(walk_loss(nodes, loss)))


if __name__ == "__main__":
    main()
