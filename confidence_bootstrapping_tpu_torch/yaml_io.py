"""A yaml reader and writer for the files a model directory holds.

The machine that runs the port has no PyYAML, so the port reads and writes
``model_config.yml`` (the JAX package's ``config.save_yaml``) and reference
``model_parameters.yml`` manifests with this module.

``dump`` writes what ``yaml.safe_dump(d, sort_keys=True)`` writes for nested
str-keyed mappings whose values are None, bools, ints, floats, strings, lists
of those, and mappings: block mappings with sorted keys, block sequences at
their key's indentation, ``[]`` and ``{}`` for empty ones, ``null``,
``true``/``false``, floats as PyYAML formats them (``1.0e-05``, ``.inf``,
``.nan``), strings plain where PyYAML writes them plain and single-quoted
where a plain one would read back as another type or breaks the syntax. It
does not fold a long line as PyYAML does past 80 columns, and writes a
string with line breaks or characters outside printable ASCII double-quoted
with escapes: those texts differ from PyYAML's and read back the same.

``load`` reads block mappings and sequences, flow ``[...]`` and ``{...}``
collections, plain, single- and double-quoted scalars (a scalar may continue
on more indented lines), and comments, and resolves plain scalars to None,
bools, ints and floats as PyYAML's ``SafeLoader`` does (YAML 1.1: ``yes``
and ``off`` are bools, ``1e-05`` without a dot is a string). It raises
``ValueError``, naming the line, on what it does not read: anchors, aliases,
tags (``!!python/tuple``), block scalars (``|``, ``>``), complex keys,
merge keys, timestamps, directives and a second document. A file that uses
one fails loudly; it is never half read.
"""

from __future__ import annotations

import math
import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_SPACE = "\0 \t\r\n\x85\u2028\u2029"
_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n", "\x0b": "v", "\x0c": "f", "\r": "r",
            "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L", "\u2029": "P"}
_UNESCAPES = {v: k for k, v in _ESCAPES.items()} | {" ": " ", "/": "/", "\t": "\t"}


# ----------------------------------------------------------------------------- writing


def dump(d: dict) -> str:
    """The text ``yaml.safe_dump(d, sort_keys=True)`` gives for a mapping
    (see the module docstring for the subset and where the text may differ)."""
    if not isinstance(d, dict):
        raise TypeError("yaml_io.dump writes a mapping")
    return "".join(_mapping(d, 0)) if d else "{}\n"


def _mapping(d: dict, indent: int):
    for k in sorted(d):
        if not isinstance(k, str):
            raise TypeError(f"yaml_io.dump writes str keys only, not {k!r}")
        if not k or "\n" in k or len(k) >= 128:
            raise ValueError(f"yaml_io.dump writes simple keys only, not {k!r}")
        v, head = d[k], " " * indent + _string(k) + ":"
        if isinstance(v, dict) and v:
            yield head + "\n"
            yield from _mapping(v, indent + 2)
        elif isinstance(v, list) and v:
            yield head + "\n"
            yield from _sequence(v, indent)
        else:
            yield head + " " + _scalar(v) + "\n"


def _sequence(items: list, indent: int):
    for v in items:
        if isinstance(v, (dict, list)) and v:
            raise TypeError("yaml_io.dump writes sequences of scalars only")
        yield " " * indent + "- " + _scalar(v) + "\n"


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        return _string(v)
    if isinstance(v, dict) and not v:
        return "{}"
    if isinstance(v, list) and not v:
        return "[]"
    raise TypeError(f"yaml_io.dump does not write {type(v).__name__}")


def _string(s: str) -> str:
    """A string as PyYAML's emitter writes it in block context: plain where
    that reads back as the same string, else single-quoted, else (line
    breaks, characters outside printable ASCII) double-quoted."""
    if any(not ("\x20" <= ch <= "\x7e") for ch in s):
        return '"' + "".join(_escape(ch) for ch in s) + '"'
    if _resolve_plain(s) is s and not _TIMESTAMP.match(s) and s not in ("<<", "=") and _plain_ok(s):
        return s
    return "'" + s.replace("'", "''") + "'"


def _escape(ch: str) -> str:
    if ch in _ESCAPES:
        return "\\" + _ESCAPES[ch]
    if "\x20" <= ch <= "\x7e":
        return ch
    if ch <= "\xff":
        return f"\\x{ord(ch):02X}"
    return f"\\u{ord(ch):04X}" if ch <= "\uffff" else f"\\U{ord(ch):08X}"


def _plain_ok(s: str) -> bool:
    """PyYAML's ``allow_block_plain`` for a printable-ASCII string."""
    if not s:
        return True
    if s[0] == " " or s[-1] == " " or s.startswith("---") or s.startswith("..."):
        return False
    for i, ch in enumerate(s):
        followed = i + 1 >= len(s) or s[i + 1] in _SPACE
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed):
                return False
        elif (ch == ":" and followed) or (ch == "#" and s[i - 1] in _SPACE):
            return False
    return True


# ----------------------------------------------------------------------------- reading


def load(text: str):
    """The data of one yaml document (see the module docstring)."""
    lines = []
    started = False
    for n, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError(f"yaml_io: line {n}: tabs in indentation are not read")
        if line.startswith("%"):
            raise ValueError(f"yaml_io: line {n}: directives are not read")
        if line == "---" or line.startswith("--- ") or line == "...":
            if started or line != "---":
                raise ValueError(f"yaml_io: line {n}: only one document is read")
            continue
        if not body or body.startswith("#"):
            lines.append((None, body, n))  # blank or comment: kept for quoted and folded scalars
            continue
        started = True
        lines.append((len(line) - len(body), body, n))
    p = _Parser(lines)
    i = p.skip(0)
    if i == len(lines):
        return None
    value, i = p.node(i, lines[i][0])
    i = p.skip(i)
    if i < len(lines):
        raise ValueError(f"yaml_io: line {lines[i][2]}: unexpected indentation")
    return value


def _resolve_plain(s: str):
    """A plain scalar's value as PyYAML's SafeLoader resolves it; the string
    itself (the same object) where it stays a string."""
    if _BOOL.match(s):
        return s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
    if _FLOAT.match(s) and s[:1] in "-+0123456789.":
        return _float(s)
    if _INT.match(s):
        return _int(s)
    if _NULL.match(s):
        return None
    return s


def _int(s: str) -> int:
    v = s.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v)
    return sign * int(v)


def _float(s: str) -> float:
    v = s.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    v = v[1:] if v[0] in "+-" else v
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _sexagesimal(v: str, kind=int):
    out = 0
    for part in v.split(":"):
        out = out * 60 + kind(part)
    return out


class _Parser:
    """Recursive descent over (indent, text, line number) lines; a blank or
    comment line has indent None."""

    def __init__(self, lines):
        self.lines = lines

    def skip(self, i: int) -> int:
        while i < len(self.lines) and self.lines[i][0] is None:
            i += 1
        return i

    def fail(self, i: int, what: str):
        n = self.lines[min(i, len(self.lines) - 1)][2]
        raise ValueError(f"yaml_io: line {n}: {what}")

    def node(self, i: int, indent: int):
        """The block node whose first line is i (at ``indent``)."""
        text = self.lines[i][1]
        if text == "-" or text.startswith("- "):
            return self.sequence(i, indent)
        if _key_end(text) is not None or text.startswith("? "):
            return self.mapping(i, indent)
        return self.value(i, indent - 1, text)

    def sequence(self, i: int, indent: int):
        out = []
        while True:
            i = self.skip(i)
            if i == len(self.lines) or self.lines[i][0] < indent:
                return out, i
            ind, text, n = self.lines[i]
            if ind > indent or not (text == "-" or text.startswith("- ")):
                if ind == indent:
                    return out, i  # the end of an indentless sequence under a key
                self.fail(i, "unexpected indentation")
            rest = text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                j = self.skip(i + 1)
                if j < len(self.lines) and self.lines[j][0] > indent:
                    v, i = self.node(j, self.lines[j][0])
                else:
                    v, i = None, i + 1
            else:  # the item's content starts on the dash's line: read it as a line of its own
                self.lines[i] = (indent + len(text) - len(rest), rest, n)
                v, i = self.node(i, self.lines[i][0])
            out.append(v)

    def mapping(self, i: int, indent: int):
        out = {}
        while True:
            i = self.skip(i)
            if i == len(self.lines) or self.lines[i][0] < indent:
                return out, i
            ind, text, _ = self.lines[i]
            if ind > indent:
                self.fail(i, "unexpected indentation")
            if text.startswith("? "):
                self.fail(i, "complex keys are not read")
            end = _key_end(text)
            if end is None:
                if text == "-" or text.startswith("- "):
                    return out, i  # a sequence at the parent key's indentation ends this mapping's caller
                self.fail(i, "expected a key")
            key = self.key(i, text[:end])
            rest = text[end + 1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                j = self.skip(i + 1)
                if j < len(self.lines) and (self.lines[j][0] > indent or (
                        self.lines[j][0] == indent and (self.lines[j][1] == "-" or self.lines[j][1].startswith("- ")))):
                    if self.lines[j][0] == indent:
                        v, i = self.sequence(j, indent)
                    else:
                        v, i = self.node(j, self.lines[j][0])
                else:
                    v, i = None, i + 1
            else:
                v, i = self.value(i, indent, rest)
            out[key] = v

    def key(self, i: int, text: str):
        text = text.rstrip(" ")
        if text[:1] in ("'", '"'):
            v, rest = _quoted(text, self, i)
            if rest.strip():
                self.fail(i, "text after a quoted key")
            return v
        self.check_plain(i, text)
        if text == "<<":
            self.fail(i, "merge keys are not read")
        return self.resolve(i, text)

    def value(self, i: int, indent: int, text: str):
        """A scalar or flow collection starting at line i's ``text``, which
        may continue on the following lines indented past ``indent``.
        Returns (value, next line)."""
        j = i + 1
        while j < len(self.lines) and (self.lines[j][0] is None or self.lines[j][0] > indent):
            j += 1
        while j > i + 1 and self.lines[j - 1][0] is None:
            j -= 1
        more = [self.lines[k] for k in range(i + 1, j)]
        if text[0] in "[{":
            src = " ".join([text] + [t for ind, t, _ in more if ind is not None])
            v, rest = _Flow(src, self, i).parse()
            if rest.strip() and not rest.lstrip().startswith("#"):
                self.fail(i, "text after a flow collection")
            return v, j
        if text[0] in ("'", '"'):
            src = "\n".join([text] + [t for _, t, _ in more])
            v, rest = _quoted(src, self, i)
            if rest.strip() and not rest.lstrip().startswith("#"):
                self.fail(i, "text after a quoted scalar")
            return v, j
        parts = [_strip_comment(text)]
        for _, t, _ in more:
            if t.startswith("#") or parts[-1] is None:
                break  # a comment ends a plain scalar
            parts.append(_strip_comment(t))
            if parts[-1] != t:
                parts.append(None)
        parts = [p for p in parts if p is not None]
        plain = _fold(parts)
        self.check_plain(i, plain)
        if ": " in plain or plain.endswith(":"):
            self.fail(i, "a mapping value is not allowed here")
        return self.resolve(i, plain), j

    def check_plain(self, i: int, s: str):
        if s[:1] in "&*":
            self.fail(i, "anchors and aliases are not read")
        if s[:1] == "!":
            self.fail(i, "tags are not read")
        if s[:1] in "|>":
            self.fail(i, "block scalars are not read")
        if s[:1] in "%@`":
            self.fail(i, f"a plain scalar cannot start with {s[0]!r}")

    def resolve(self, i: int, s: str):
        if _TIMESTAMP.match(s):
            self.fail(i, "timestamps are not read")
        if s == "=":
            self.fail(i, "the value key '=' is not read")
        return _resolve_plain(s)


def _key_end(text: str):
    """The index of the ':' that ends a simple key on this line, or None."""
    if text[:1] in ("'", '"'):
        q, k = text[0], 1
        while k < len(text):
            if text[k] == q:
                if q == "'" and text[k + 1: k + 2] == "'":
                    k += 2
                    continue
                break
            k += 2 if q == '"' and text[k] == "\\" else 1
        rest = text[k + 1:]
        stripped = rest.lstrip(" ")
        if stripped.startswith(":") and (len(stripped) == 1 or stripped[1] == " "):
            return k + 1 + len(rest) - len(stripped)
        return None
    if text[:1] in "[{#" or text == "-" or text.startswith("- "):
        return None
    for k, ch in enumerate(text):
        if ch == "#" and k > 0 and text[k - 1] == " ":
            return None
        if ch == ":" and (k + 1 == len(text) or text[k + 1] == " "):
            return k if k > 0 else None
    return None


def _strip_comment(text: str) -> str:
    for k, ch in enumerate(text):
        if ch == "#" and k > 0 and text[k - 1] == " ":
            return text[:k].rstrip(" ")
    return text


def _fold(parts) -> str:
    """Line folding of a multi-line scalar: a line break becomes a space, an
    empty line a line break."""
    out, pending = parts[0].strip(" "), 0
    for p in parts[1:]:
        p = p.strip(" ")
        if not p:
            pending += 1
            continue
        out += ("\n" * pending) if pending else " "
        out += p
        pending = 0
    return out


def _quoted(src: str, parser, i: int):
    """A single- or double-quoted scalar at the start of ``src`` (lines
    joined by \\n): (its value, the text after it)."""
    q, k, chars = src[0], 1, []
    while True:
        if k >= len(src):
            parser.fail(i, "an unterminated quoted scalar")
        ch = src[k]
        if ch == q:
            if q == "'" and src[k + 1: k + 2] == "'":
                chars.append("'")
                k += 2
                continue
            break
        if q == '"' and ch == "\\":
            nxt = src[k + 1: k + 2]
            if nxt == "\n":  # an escaped line break: joined with no space
                k += 2
                while k < len(src) and src[k] in " \t":
                    k += 1
                continue
            if nxt in _UNESCAPES:
                chars.append(_UNESCAPES[nxt])
                k += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(nxt)
            if width is None:
                parser.fail(i, f"an unknown escape \\{nxt}")
            chars.append(chr(int(src[k + 2: k + 2 + width], 16)))
            k += 2 + width
            continue
        if ch == "\n":  # folding inside a quoted scalar
            while chars and chars[-1] in " \t":
                chars.pop()
            k += 1
            breaks = 0
            while k < len(src) and src[k] in " \t\n":
                breaks += src[k] == "\n"
                k += 1
            chars.append("\n" * breaks if breaks else " ")
            continue
        chars.append(ch)
        k += 1
    return "".join(chars), src[k + 1:]


class _Flow:
    """A flow collection ``[...]`` or ``{...}`` of scalars and flow
    collections, on one logical line."""

    def __init__(self, src: str, parser, i: int):
        self.src, self.k, self.parser, self.i = src, 0, parser, i

    def parse(self):
        v = self.node()
        return v, self.src[self.k:]

    def ws(self):
        while self.k < len(self.src) and self.src[self.k] == " ":
            self.k += 1

    def node(self):
        self.ws()
        ch = self.src[self.k: self.k + 1]
        if ch == "[":
            return self.collection("]")
        if ch == "{":
            return self.collection("}")
        if ch in ("'", '"'):
            v, rest = _quoted(self.src[self.k:], self.parser, self.i)
            self.k = len(self.src) - len(rest)
            return v
        start = self.k
        while self.k < len(self.src):
            c = self.src[self.k]
            if c in ",]}" or (c == ":" and self.src[self.k + 1: self.k + 2] in ("", " ", ",", "]", "}")):
                break
            if c == "#" and self.src[self.k - 1] == " ":
                self.parser.fail(self.i, "a comment inside a flow collection")
            self.k += 1
        text = self.src[start:self.k].strip(" ")
        self.parser.check_plain(self.i, text)
        if text[:1] in "[]{},?":
            self.parser.fail(self.i, f"unexpected {text[:1]!r} in a flow collection")
        return self.parser.resolve(self.i, text)

    def collection(self, close: str):
        self.k += 1
        out = [] if close == "]" else {}
        while True:
            self.ws()
            if self.src[self.k: self.k + 1] == close:
                self.k += 1
                return out
            item = self.node()
            self.ws()
            if self.src[self.k: self.k + 1] == ":":
                self.k += 1
                value = self.node()
                if close == "]":
                    out.append({item: value})
                else:
                    out[item] = value
            elif close == "}":
                out[item] = None
            else:
                out.append(item)
            self.ws()
            c = self.src[self.k: self.k + 1]
            if c == ",":
                self.k += 1
            elif c != close:
                self.parser.fail(self.i, f"expected ',' or {close!r} in a flow collection")
