"""Emit csrc/wall_img_terms.cuh, the CUDA form of the generated image
channel apply `img_terms` (ops/_wall_channels_gen.py), for kernel K7
(csrc/wall_near.cu).

    python -m rigidmultiblobswall_tpu_torch.ops._emit_wall_cuh

rewrites the header; tests/test_torch_wall_spectral.py checks that the
committed header equals a fresh emission. The Python body is read with
`ast` and written out statement by statement as a templated __device__
function. Two rules keep its arithmetic that of the Python: a constant
subexpression becomes one literal of the template type, T(4.0/3.0) for
(4/3) (in C, 4/3 is integer division and equals 1), and x**n with an
integer n becomes a product of n factors.
"""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

from . import _wall_channels_gen as gen

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "wall_img_terms.cuh"

_OPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}


def _const_text(node):
    """C text of a constant subexpression (numbers, unary minus and
    + - * / of them) with every number written as a double literal, or
    None when the node is not constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return repr(float(node.value))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_text(node.operand)
        return None if inner is None else f"-{inner}"
    if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
        lhs, rhs = _const_text(node.left), _const_text(node.right)
        if lhs is None or rhs is None:
            return None
        return f"({lhs} {_OPS[type(node.op)]} {rhs})"
    return None


def _expr(node):
    const = _const_text(node)
    if const is not None:
        return f"T({const})"
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return f"(-{_expr(node.operand)})"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
        n = node.right
        if not (isinstance(n, ast.Constant) and isinstance(n.value, int)
                and n.value >= 1):
            raise ValueError(f"unsupported power {ast.dump(n)}")
        base = _expr(node.left)
        return "(" + "*".join([base] * n.value) + ")"
    if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
        return (f"({_expr(node.left)} {_OPS[type(node.op)]} "
                f"{_expr(node.right)})")
    raise ValueError(f"unsupported expression {ast.dump(node)}")


def emit(fn=gen.img_terms) -> str:
    """The header's text for the generated function `fn`."""
    tree = ast.parse(inspect.getsource(fn))
    func = tree.body[0]
    args = [a.arg for a in func.args.args]
    body = []
    outs = None
    for stmt in func.body:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue                                    # the docstring
        if isinstance(stmt, ast.Assign):
            (target,) = stmt.targets
            body.append(f"  const T {target.id} = {_expr(stmt.value)};")
        elif isinstance(stmt, ast.Return):
            outs = [e.id for e in stmt.value.elts]
        else:
            raise ValueError(f"unsupported statement {ast.dump(stmt)}")
    params = ", ".join(f"T {a}" for a in args)
    refs = ", ".join(f"T& {o}_out" for o in outs)
    lines = [
        f"// GENERATED by rigidmultiblobswall_tpu_torch/ops/_emit_wall_cuh.py "
        f"from",
        f"// ops/_wall_channels_gen.py ({fn.__name__}) -- do not edit.",
        "//",
        "// (T0 + h T1 + h^2 T2) f of the Swan-Brady image channels at the "
        "image",
        "// displacement (dx, dy, rz), source height h, equal radii A2, from "
        "the",
        "// ten radial values c4_0..c4_4, c2_0..c2_4 (see the Python "
        "docstring).",
        "",
        "#pragma once",
        "",
        "namespace wallk {",
        "",
        "template <typename T>",
        f"__device__ __forceinline__ void {fn.__name__}({params},",
        f"    {refs}) {{",
        *body,
        *(f"  {o}_out = {o};" for o in outs),
        "}",
        "",
        "}  // namespace wallk",
        "",
    ]
    return "\n".join(lines)


def main():
    HEADER.write_text(emit())
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
