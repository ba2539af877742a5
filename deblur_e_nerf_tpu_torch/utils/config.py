"""Configuration loading (counterpart of deblur_e_nerf_tpu/utils/config.py).

Same YAML schema and the same attribute-access `ConfigDict`;
`ConfigDict.from_dict` builds a config in code. Neither loading nor saving
needs PyYAML (the GPU machine has none). `load_config` reads with
`yaml_load`, a reader of the YAML subset the repo's configs and Kalibr's
camera chains are written in: block mappings, block sequences of scalars,
flow values and nested sequences (`- [1.0, 0.0]`, and `- - 1.0` as
`yaml.safe_dump` writes a list of lists), flow mappings and sequences
(also as the whole document), plain and quoted scalars resolved as PyYAML
resolves them, comments.
`save_config` writes with `yaml_text`, which emits only that subset (block
mappings, every list in flow style), so both readers load it back to the
same values.
"""

import copy
import json
import math
import numbers
import re


class ConfigDict(dict):
    """A dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for key, value in d.items():
            self[key] = value

    @classmethod
    def from_dict(cls, d):
        return cls(copy.deepcopy(dict(d)))

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        def unwrap(value):
            if isinstance(value, ConfigDict):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return type(value)(unwrap(v) for v in value)
            return value

        return unwrap(self)


def load_config(path):
    """Load a YAML config file (reference schema) into a ConfigDict."""
    with open(path) as f:
        return ConfigDict(yaml_load(f.read()))


# PyYAML's (YAML 1.1) implicit scalar types, without the sexagesimal forms
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_YAML_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                               "on", "On", "ON"), True),
              **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF"), False)}
_YAML_INT = {10: re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$"),
             2: re.compile(r"^[-+]?0b[0-1_]+$"),
             8: re.compile(r"^[-+]?0[0-7_]+$"),
             16: re.compile(r"^[-+]?0x[0-9a-fA-F_]+$")}
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_YAML_SPECIAL = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                 "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                 "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                 ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}


def _yaml_plain(text):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if _YAML_NULL.match(text):
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    for base, pattern in _YAML_INT.items():
        if pattern.match(text):
            digits = text.replace("_", "")
            sign = -1 if digits[0] == "-" else 1
            digits = digits.lstrip("+-")
            return sign * int(digits[2:] if base in (2, 16) else digits, base)
    if _YAML_FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _YAML_SPECIAL:
        return _YAML_SPECIAL[text]
    return text


def _yaml_scalar_end(text, i, stops):
    """The end of the scalar starting at text[i]: past its closing quote,
    or at the first character in `stops`."""
    if text[i] == '"':
        i += 1
        while text[i] != '"':
            i += 2 if text[i] == "\\" else 1
        return i + 1
    if text[i] == "'":
        i = text.index("'", i + 1)
        while text[i + 1:i + 2] == "'":  # '' is an escaped quote
            i = text.index("'", i + 2)
        return i + 1
    while i < len(text) and text[i] not in stops:
        i += 1
    return i


def _yaml_flow(text, i):
    """Parse the flow value starting at text[i]; returns (value, next i)."""
    while text[i] == " ":
        i += 1
    if text[i] in "{[":
        close = "}" if text[i] == "{" else "]"
        items = {} if close == "}" else []
        i += 1
        while True:
            while text[i] in " ,":
                i += 1
            if text[i] == close:
                return items, i + 1
            if close == "]":
                value, i = _yaml_flow(text, i)
                items.append(value)
                continue
            end = _yaml_scalar_end(text, i, ":,}")
            key = _yaml_plain(text[i:end])
            colon = text.index(":", end)
            items[key], i = _yaml_flow(text, colon + 1)
    end = _yaml_scalar_end(text, i, ",}]")
    return _yaml_plain(text[i:end]), end


def _yaml_scan(line):
    """`line` without its comment, and how many brackets it leaves open
    (quoted text is skipped)."""
    quote, depth, k = None, 0, 0
    while k < len(line):
        ch = line[k]
        if quote:
            if ch == "\\" and quote == '"':
                k += 1
            elif ch == quote:
                quote = None
        elif ch in "\"'" and line[:k].rstrip()[-1:] in ("", ":", "[",
                                                         "{", ",", "-"):
            quote = ch  # a quote opens only at the start of a scalar
        elif ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        elif ch == "#" and (k == 0 or line[k - 1] in " \t"):
            return line[:k].rstrip(), depth
        k += 1
    return line.rstrip(), depth


def _yaml_is_item(body):
    return body == "-" or body.startswith("- ")


def _yaml_node(lines, i, indent):
    """The block value (mapping or sequence) whose entries start at
    lines[i], at `indent`; returns (value, next line)."""
    if _yaml_is_item(lines[i][1]):
        return _yaml_sequence(lines, i, indent)
    return _yaml_mapping(lines, i, indent)


def _yaml_after(lines, i, indent):
    """The value of an entry whose text ended on line i - 1 at `indent`:
    the block on the lines below it (deeper, or a sequence at the same
    indent, as PyYAML's `key:` then `- item`), or null."""
    if i < len(lines) and (lines[i][0] > indent or (
            lines[i][0] == indent and _yaml_is_item(lines[i][1]))):
        return _yaml_node(lines, i, lines[i][0])
    return None, i


def _yaml_sequence(lines, i, indent):
    """A block sequence: `- scalar`, `- [flow]`, or `- - ...` (a nested
    sequence, as yaml.safe_dump writes a list of lists); an item that is
    a mapping or empty raises ValueError."""
    items = []
    while i < len(lines) and lines[i][0] == indent \
            and _yaml_is_item(lines[i][1]):
        body = lines[i][1][1:]
        rest = body.lstrip(" ")
        if _yaml_is_item(rest):  # `- - x`: the inner item starts here
            lines[i] = (indent + 1 + len(body) - len(rest), rest)
            value, i = _yaml_sequence(lines, i, lines[i][0])
            items.append(value)
            continue
        end = _yaml_scalar_end(rest, 0, ":") if rest else 0
        if not rest or (rest[0] not in "[{" and rest[end:end + 1] == ":"
                        and rest[end + 1:end + 2] in ("", " ")):
            raise ValueError(f"only scalars, flow values and sequences are "
                             f"supported as sequence items: "
                             f"{lines[i][1]!r}")
        value, end = _yaml_flow(rest, 0)
        if rest[end:].strip():
            raise ValueError(f"trailing text in {lines[i][1]!r}")
        items.append(value)
        i += 1
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation: {lines[i][1]!r}")
    return items, i


def _yaml_mapping(lines, i, indent):
    mapping = {}
    while i < len(lines) and lines[i][0] == indent \
            and not _yaml_is_item(lines[i][1]):
        body = lines[i][1]
        end = _yaml_scalar_end(body, 0, ":")
        key, sep, rest = body[:end], body[end:end + 1], body[end + 1:]
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"not a mapping entry: {body!r}")
        key = _yaml_plain(key)
        i += 1
        if rest.strip():
            value, end = _yaml_flow(rest, 0)
            if rest[end:].strip():
                raise ValueError(f"trailing text in {body!r}")
            mapping[key] = value
        else:
            mapping[key], i = _yaml_after(lines, i, indent)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation: {lines[i][1]!r}")
    return mapping, i


def yaml_load(text):
    """Load the YAML subset of the repo's configs and of Kalibr's camera
    chains (see the module docstring) into nested dicts, lists and
    scalars; anything outside it raises ValueError."""
    lines = []
    open_brackets = 0
    for raw in text.splitlines():
        line, depth = _yaml_scan(raw)
        if not line.strip():
            continue
        if open_brackets > 0:  # inside a multi-line flow value
            indent, body = lines[-1]
            lines[-1] = (indent, body + " " + line.strip())
            open_brackets += depth
            continue
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
        open_brackets = depth
    if not lines:
        return {}
    if lines[0][1][0] in "[{":  # the document is one flow value
        value, end = _yaml_flow(lines[0][1], 0)
        if len(lines) > 1 or lines[0][1][end:].strip():
            raise ValueError(f"trailing text after {lines[0][1]!r}")
        return value
    value, i = _yaml_node(lines, 0, lines[0][0])
    if i < len(lines):
        raise ValueError(f"unexpected indentation: {lines[i][1]!r}")
    return value


def save_config(config, path):
    with open(path, "w") as f:
        f.write(yaml_text(
            config.to_dict() if isinstance(config, ConfigDict) else config))


def yaml_float(value):
    """A float as a YAML 1.1 float scalar that reads back exactly."""
    value = float(value)
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value)
    mantissa, _, exponent = text.partition("e")
    if "." not in mantissa:  # YAML 1.1 floats need a dot
        mantissa += ".0"
    return mantissa + ("e" + exponent if exponent else "")


def _yaml_flow_text(value):
    """`value` in flow style: {"key": ...}, [...], scalars."""
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_yaml_flow_text(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_flow_text(v) for v in value) + "]"
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, numbers.Real):
        return yaml_float(value)
    return json.dumps(str(value))


def _yaml_block(mapping, indent):
    lines = []
    for key, item in mapping.items():
        head = f"{' ' * indent}{json.dumps(str(key))}:"
        if isinstance(item, dict) and item:
            lines += [head] + _yaml_block(item, indent + 2)
        else:
            lines.append(f"{head} {_yaml_flow_text(item)}")
    return lines


def yaml_text(value):
    """YAML of nested dicts, lists and scalars in the subset `yaml_load`
    reads: non-empty mappings as block mappings, everything else in flow
    style (a top-level list one item a line); keys and strings
    double-quoted, floats exact."""
    if isinstance(value, dict) and value:
        return "\n".join(_yaml_block(value, 0)) + "\n"
    if isinstance(value, (list, tuple)) and value:
        return "[" + ",\n ".join(_yaml_flow_text(v) for v in value) + "]\n"
    return _yaml_flow_text(value) + "\n"
