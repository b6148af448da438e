""".pbrt scene-description tokenizer and typed parameter lookups.

The port's copy of the JAX package's ``scene/parser.py`` (reference
src/bin/rs_pbrt.rs: the pest grammar examples/rs_pbrt.pest and
parse_file/parse_line :444-888).  A hand tokenizer reads identifiers,
quoted strings, numbers, brackets and '#' comments; a statement's
parameters are `"type name" [ values ]` pairs collected into a dict, the
reference's ParamSet (src/core/paramset.rs:28).  Host Python and numpy.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..io.floatfile import read_float_file
from ..utils import spectrum as sp

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<comment>\#[^\n]*) |
      (?P<string>"[^"]*") |
      (?P<lbracket>\[) |
      (?P<rbracket>\]) |
      (?P<number>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?) |
      (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)

# statements taking N bare numeric operands (parse_line :444-771)
_NUM_ARG_STATEMENTS = {
    "Translate": 3,
    "Scale": 3,
    "Rotate": 4,
    "LookAt": 9,
    "Transform": 16,
    "ConcatTransform": 16,
    "TransformTimes": 2,
}
# statements taking quoted-string operands then params
_NAMED_STATEMENTS = {
    "Accelerator": 1,
    "AreaLightSource": 1,
    "Camera": 1,
    "CoordinateSystem": 1,
    "CoordSysTransform": 1,
    "Film": 1,
    "Include": 1,
    "Integrator": 1,
    "LightSource": 1,
    "MakeNamedMaterial": 1,
    "MakeNamedMedium": 1,
    "Material": 1,
    "MediumInterface": 2,
    "NamedMaterial": 1,
    "ObjectBegin": 1,
    "ObjectInstance": 1,
    "PixelFilter": 1,
    "Sampler": 1,
    "Shape": 1,
    "Texture": 3,
    "ActiveTransform": 1,
}
_BARE_STATEMENTS = {
    "AttributeBegin", "AttributeEnd", "Identity", "ObjectEnd",
    "ReverseOrientation", "TransformBegin", "TransformEnd", "WorldBegin",
    "WorldEnd",
}

PARAM_TYPES = {
    "integer", "float", "bool", "string", "point", "point2", "point3",
    "vector", "vector2", "vector3", "normal", "rgb", "color", "xyz",
    "spectrum", "blackbody", "texture",
}


def tokenize(text: str):
    """(kind, value) tokens of a scene file's text: "str", "num" (a float),
    "lb", "rb" and "ident"; comments skipped.  SyntaxError on a character
    no token starts with."""
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise SyntaxError(f"pbrt parse error at char {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment" or kind is None:
            continue
        val = m.group(kind)
        if kind == "string":
            yield ("str", val[1:-1])
        elif kind == "number":
            yield ("num", float(val))
        elif kind == "lbracket":
            yield ("lb", None)
        elif kind == "rbracket":
            yield ("rb", None)
        else:
            yield ("ident", val)


class Statement:
    __slots__ = ("name", "args", "params")

    def __init__(self, name, args, params):
        self.name = name
        self.args = args  # list of strings/floats
        self.params = params  # dict: name -> (type, values list)

    def __repr__(self):
        return f"Statement({self.name}, {self.args}, {list(self.params)})"


def _parse_params(toks, i):
    """Collect `"type name" [vals]` pairs until next identifier."""
    params = {}
    while i < len(toks) and toks[i][0] == "str":
        decl = toks[i][1].split()
        if len(decl) != 2 or decl[0] not in PARAM_TYPES:
            break  # a bare string operand of the next statement
        ptype, pname = decl
        i += 1
        vals = []
        if i < len(toks) and toks[i][0] == "lb":
            i += 1
            while i < len(toks) and toks[i][0] != "rb":
                k, v = toks[i]
                vals.append(v if k in ("num", "str") else v)
                if k == "ident":  # true/false
                    vals[-1] = v
                i += 1
            i += 1  # skip rb
        else:  # single unbracketed value
            k, v = toks[i]
            vals.append(v)
            i += 1
        params[pname] = (ptype, vals)
    return params, i


def parse_statements(text: str, search_dir: Path = None):
    """Yields the text's Statements, an Include's file expanded in place
    (rs_pbrt.rs:530-549), its path relative to search_dir."""
    toks = list(tokenize(text))
    i = 0
    n = len(toks)
    while i < n:
        kind, val = toks[i]
        if kind != "ident":
            raise SyntaxError(f"expected statement, got {toks[i]}")
        name = val
        i += 1
        if name in _NUM_ARG_STATEMENTS:
            count = _NUM_ARG_STATEMENTS[name]
            args = []
            while len(args) < count and i < n and toks[i][0] in ("num", "lb", "rb"):
                if toks[i][0] == "num":
                    args.append(toks[i][1])
                i += 1
            yield Statement(name, args, {})
        elif name in _NAMED_STATEMENTS:
            n_args = _NAMED_STATEMENTS[name]
            args = []
            # ActiveTransform's operand is a bare keyword (All/StartTime/
            # EndTime), not a quoted string
            ok_kinds = ("str", "ident") if name == "ActiveTransform" else ("str",)
            while len(args) < n_args and i < n and toks[i][0] in ok_kinds:
                args.append(toks[i][1])
                i += 1
            params, i = _parse_params(toks, i)
            if name == "Include":
                inc = Path(args[0])
                if search_dir and not inc.is_absolute():
                    inc = search_dir / inc
                yield from parse_statements(inc.read_text(), inc.parent)
            else:
                yield Statement(name, args, params)
        elif name in _BARE_STATEMENTS:
            yield Statement(name, [], {})
        else:
            raise SyntaxError(f"unknown pbrt statement {name!r}")


def parse_file(path):
    path = Path(path)
    return parse_statements(path.read_text(), path.parent)


# ---- typed lookups (paramset.rs find_one_* :419-490) ----

def find_one(params, name, default, want=None):
    if name not in params:
        return default
    ptype, vals = params[name]
    v = vals[0]
    if ptype == "bool" or isinstance(v, str) and v in ("true", "false"):
        return v == "true" if isinstance(v, str) else bool(v)
    if ptype == "integer":
        return int(v)
    return v


def find_floats(params, name, default=None):
    if name not in params:
        return default
    return [float(v) for v in params[name][1]]


def find_ints(params, name, default=None):
    if name not in params:
        return default
    return [int(v) for v in params[name][1]]


def find_string(params, name, default=None):
    if name not in params:
        return default
    return str(params[name][1][0])


def find_spectrum(params, name, default=None):
    """rgb/color/xyz/blackbody/spectrum -> an rgb triple (paramset.rs:292).
    A spectrum is inline (lambda, value) pairs or an .spd file's name."""
    if name not in params:
        return default
    ptype, vals = params[name]
    if ptype in ("rgb", "color"):
        return tuple(float(v) for v in vals[:3])
    if ptype == "xyz":
        return tuple(sp.xyz_to_rgb(np.asarray(vals[:3], np.float32)))
    if ptype == "blackbody":
        temp = float(vals[0])
        scale = float(vals[1]) if len(vals) > 1 else 1.0
        lams = np.linspace(400, 700, 60)
        spd = sp.blackbody_normalized(lams, temp) * scale
        return tuple(sp.spd_to_rgb(lams, spd))
    if ptype == "spectrum":
        if isinstance(vals[0], str):
            data = read_float_file(vals[0])
            lams, vs = data[0::2], data[1::2]
        else:
            lams, vs = vals[0::2], vals[1::2]
        return tuple(sp.spd_to_rgb(lams, vs))
    return tuple(float(v) for v in vals[:3])
