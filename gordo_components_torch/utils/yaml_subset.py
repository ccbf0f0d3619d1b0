"""A reader for the subset of YAML that fleet files use.

The port depends on no YAML library, so it reads fleet files and
YAML-valued options here. :func:`safe_load` returns what ``yaml.safe_load``
(PyYAML 6, YAML 1.1) returns for the same text, within this subset:

- block mappings and block sequences, a sequence also at its key's own
  indentation, and ``- key: value`` items whose mapping continues on the
  lines below;
- flow sequences ``[a, b]`` and flow mappings ``{a: 1, b}``, nested, on one
  line or over several;
- plain, single-quoted and double-quoted scalars, each on one line, with
  the escapes double quotes allow;
- whole-line and trailing comments, and empty values (null).

Plain scalars resolve as YAML 1.1 resolves them: ``yes``/``No``/``ON``...
are booleans; ``~``, ``null`` and an empty value are None; ints take
``0b``, ``0x``, a leading ``0`` (octal), ``_`` and ``1:30`` (base 60);
floats need a dot, and an exponent needs its sign (``1e3`` and ``1.0e3``
stay strings, ``1.0e+3`` is 1000.0), with ``.inf`` and ``.nan``;
``2020-01-01`` is a date and ``2020-01-01T00:00:00Z`` an aware datetime.
Every other plain scalar is a string, and so is every quoted one.

Anything outside the subset raises :class:`YAMLSubsetError` with its line
number, and nothing is returned: anchors, aliases, tags, directives,
document markers, block scalars (``|``, ``>``), complex and merge keys
(``?``, ``<<``), scalars over several lines, a single-pair mapping inside
a flow sequence, tabs, and text YAML itself refuses.
"""

import datetime
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "safe_load"]


class YAMLSubsetError(ValueError):
    """Text outside the subset, or not YAML at all."""

    def __init__(self, message: str, line: Optional[int] = None):
        super().__init__(f"line {line}: {message}" if line else message)
        self.line = line


# the implicit resolvers of YAML 1.1 (PyYAML's ``Resolver``)
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
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[\ \t]+)[0-9][0-9]?
     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
    -(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
    (?:(?:[Tt]|[\ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
    (?:\.(?P<fraction>[0-9]*))?
    (?:[\ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)(?::(?P<tz_minute>[0-9][0-9]))?))?)?$""",
                              re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_NON_PRINTABLE = re.compile("[^\x0a\x0d\x20-\x7e\xa0-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")
_FLOW_END = " ,[]{}"


def _sexagesimal(value: str, cast):
    out = cast(0)
    for part in value.split(":"):
        out = out * 60 + cast(part)
    return out


def _to_int(s: str) -> int:
    value = s.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(s: str) -> float:
    value = s.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _to_timestamp(s: str):
    v = _TIMESTAMP_PARTS.match(s).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]), int(v["second"]),
                             fraction, tzinfo=tzinfo)


def _resolve(s: str, line: int) -> Any:
    """A plain scalar's value, as YAML 1.1's implicit resolvers give it."""
    try:
        if _NULL.match(s):
            return None
        if _BOOL.match(s):
            return s.lower() in ("yes", "true", "on")
        if _INT.match(s):
            return _to_int(s)
        if _FLOAT.match(s):
            return _to_float(s)
        if _TIMESTAMP.match(s):
            return _to_timestamp(s)
    except ValueError as exc:
        raise YAMLSubsetError(f"cannot read {s!r}: {exc}", line) from None
    if s in ("<<", "="):
        raise YAMLSubsetError(f"{s!r} (a merge key or value indicator) is not supported", line)
    return s


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _lines(text: str) -> List[_Line]:
    """The lines that hold content: blank and comment-only lines dropped,
    trailing whitespace cut; refuses what YAML or this subset refuses on
    sight."""
    if text.startswith("\ufeff"):
        text = text[1:]
    out = []
    for no, raw in enumerate(text.split("\n"), 1):
        raw = raw[:-1] if raw.endswith("\r") else raw
        bad = _NON_PRINTABLE.search(raw)
        if bad:
            what = "tabs are" if bad.group() == "\t" else f"character {bad.group()!r} is"
            raise YAMLSubsetError(f"{what} not supported", no)
        body = raw.lstrip(" ")
        if not body or body.startswith("#"):
            continue
        indent = len(raw) - len(body)
        if indent == 0 and (body.startswith("%") or re.match(r"(---|\.\.\.)( |$)", body)):
            raise YAMLSubsetError("directives and document markers are not supported", no)
        out.append(_Line(no, indent, raw.rstrip(" ")))
    return out


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.fli = self.fc = 0  # the flow scanner's line and column

    def fail(self, message: str, li: int):
        no = self.lines[min(li, len(self.lines) - 1)].no
        raise YAMLSubsetError(message, no)

    # ---- scalars ----

    def quoted(self, li: int, col: int) -> Tuple[str, int]:
        """The quoted scalar at ``col`` and the column after it."""
        text, q = self.lines[li].text, self.lines[li].text[col]
        out, i = [], col + 1
        while i < len(text):
            ch = text[i]
            if ch == q:
                if q == "'" and text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and ch == "\\":
                e = text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                n = _ESCAPE_CODES.get(e)
                code = text[i + 2:i + 2 + n] if n else ""
                if not n or len(code) != n or not re.fullmatch("[0-9a-fA-F]+", code):
                    self.fail(f"unknown escape in a double-quoted scalar: {text[i:i + 2 + (n or 0)]!r}"
                              if e else "a quoted scalar over several lines is not supported", li)
                out.append(chr(int(code, 16)))
                i += 2 + n
                continue
            out.append(ch)
            i += 1
        self.fail("a quoted scalar over several lines is not supported", li)

    def check_plain_start(self, li: int, col: int, flow: bool) -> None:
        text = self.lines[li].text
        ch, nxt = text[col], text[col + 1:col + 2]
        refused = {"&": "anchors are", "*": "aliases are", "!": "tags are",
                   "|": "block scalars are", ">": "block scalars are"}
        if ch in refused:
            self.fail(f"{refused[ch]} not supported", li)
        # in a flow collection '?' and ':' are indicators wherever they stand
        if ch in "%@`,[]{}#" or (flow and ch in "?:") or (ch in "-?:" and nxt in ("", " ")) \
                or (flow and ch == "-" and nxt in _FLOW_END):
            self.fail(f"{ch!r} cannot start a value here", li)

    def block_scalar(self, li: int, col: int) -> Any:
        """The scalar that fills the rest of line ``li`` from ``col``."""
        text = self.lines[li].text
        if text[col] in "'\"":
            value, end = self.quoted(li, col)
            self.end_of_line(li, end)
            return value
        self.check_plain_start(li, col, flow=False)
        end = len(text)
        for k in range(col, len(text)):
            if text[k] == "#" and text[k - 1] == " ":
                end = k
                break
            if text[k] == ":" and text[k + 1:k + 2] in ("", " "):
                self.fail("a mapping value is not allowed here", li)
        return _resolve(text[col:end].rstrip(" "), self.lines[li].no)

    def end_of_line(self, li: int, col: int) -> None:
        """Only spaces and a comment may follow a complete value."""
        text = self.lines[li].text
        k = col
        while k < len(text) and text[k] == " ":
            k += 1
        if k == len(text) or (k > col and text[k] == "#"):
            return
        if text[k] == ":":
            self.fail("only plain and quoted scalars can be mapping keys", li)
        self.fail(f"unexpected {text[k:k + 20]!r} after a value", li)

    # ---- block structure ----

    def is_seq_entry(self, li: int, col: int) -> bool:
        line = self.lines[li]
        return (line.indent == col and line.text[col] == "-"
                and line.text[col + 1:col + 2] in ("", " "))

    def mapping_key(self, li: int, col: int) -> Optional[Tuple[Any, int]]:
        """(key, column after its ':') when a block mapping entry starts at
        ``col``; else None."""
        text = self.lines[li].text
        ch = text[col]
        if ch in "'\"":
            key, end = self.quoted(li, col)
            k = end
            while k < len(text) and text[k] == " ":
                k += 1
            if k < len(text) and text[k] == ":" and text[k + 1:k + 2] in ("", " "):
                return key, k + 1
            return None
        if ch == "?" and text[col + 1:col + 2] in ("", " "):
            self.fail("complex keys ('?') are not supported", li)
        if ch in "[{":
            return None
        for k in range(col, len(text)):
            if text[k] == "#" and k > col and text[k - 1] == " ":
                return None
            if text[k] == ":" and text[k + 1:k + 2] in ("", " "):
                self.check_plain_start(li, col, flow=False)
                return _resolve(text[col:k].rstrip(" "), self.lines[li].no), k + 1
        return None

    def after_inline(self, li: int, parent: int) -> int:
        """The next line after a value that ended on line ``li``; a line
        indented deeper than ``parent`` would continue it."""
        nxt = li + 1
        if nxt < len(self.lines) and self.lines[nxt].indent > parent:
            self.fail("a value over several lines (or an indentation error) is not supported", nxt)
        return nxt

    def node(self, li: int, col: int, parent: int) -> Tuple[Any, int]:
        """The node that starts at (``li``, ``col``) inside a block collection
        indented ``parent``; returns (value, the next line to read)."""
        text = self.lines[li].text
        if text[col] == "-" and text[col + 1:col + 2] in ("", " "):
            return self.block_seq(li, col)
        if text[col] not in "[{" and self.mapping_key(li, col) is not None:
            return self.block_map(li, col)
        return self.inline(li, col, parent)

    def inline(self, li: int, col: int, parent: int) -> Tuple[Any, int]:
        """A flow collection or a scalar that starts at (``li``, ``col``)."""
        if self.lines[li].text[col] in "[{":
            value = self.flow(li, col)
            self.end_of_line(self.fli, self.fc)
            return value, self.after_inline(self.fli, parent)
        return self.block_scalar(li, col), self.after_inline(li, parent)

    def nested(self, li: int, indent: int) -> Tuple[Any, int]:
        """The value of an entry with nothing after its indicator on line
        ``li``: the block node on the lines below, or None."""
        nxt = li + 1
        if nxt < len(self.lines) and self.lines[nxt].indent > indent:
            return self.node(nxt, self.lines[nxt].indent, indent)
        return None, nxt

    def block_seq(self, li: int, n: int) -> Tuple[List[Any], int]:
        out, col = [], n
        while True:
            text = self.lines[li].text
            j = col + 1
            while j < len(text) and text[j] == " ":
                j += 1
            if j == len(text) or text[j] == "#":
                item, li = self.nested(li, n)
            else:
                item, li = self.node(li, j, n)
            out.append(item)
            if li >= len(self.lines) or self.lines[li].indent < n:
                return out, li
            if self.lines[li].indent > n:
                self.fail("unexpected indentation in a sequence", li)
            if not self.is_seq_entry(li, n):
                return out, li  # a key at the sequence's indentation: the mapping around it goes on
            col = n

    def block_map(self, li: int, m: int) -> Tuple[Dict[Any, Any], int]:
        out, col = {}, m
        while True:
            entry = self.mapping_key(li, col)
            if entry is None:
                self.fail("expected a 'key: value' entry", li)
            key, vcol = entry
            text = self.lines[li].text
            j = vcol
            while j < len(text) and text[j] == " ":
                j += 1
            if j == len(text) or text[j] == "#":
                nxt = li + 1
                if nxt < len(self.lines) and self.lines[nxt].indent == m and self.is_seq_entry(nxt, m):
                    value, li = self.block_seq(nxt, m)
                else:
                    value, li = self.nested(li, m)
            elif text[j] == "-" and text[j + 1:j + 2] in ("", " "):
                self.fail("a block sequence cannot start on its key's line", li)
            else:
                value, li = self.inline(li, j, m)
            out[key] = value
            if li >= len(self.lines) or self.lines[li].indent < m:
                return out, li
            if self.lines[li].indent > m or self.is_seq_entry(li, m):
                self.fail("expected a mapping key at this indentation", li)
            col = m

    # ---- flow collections, which may run over several lines ----

    def fpeek(self) -> str:
        text = self.lines[self.fli].text
        return text[self.fc] if self.fc < len(text) else "\n"

    def fskip(self) -> None:
        """Skip spaces, line ends and comments inside a flow collection."""
        while True:
            text = self.lines[self.fli].text
            start = self.fc
            while self.fc < len(text) and text[self.fc] == " ":
                self.fc += 1
            if self.fc < len(text) and text[self.fc] == "#":
                if self.fc == start and self.fc > 0:
                    self.fail("a comment must follow a space", self.fli)
                self.fc = len(text)
            if self.fc < len(text):
                return
            if self.fli + 1 >= len(self.lines):
                self.fail("a flow collection is not closed", self.fli)
            self.fli, self.fc = self.fli + 1, 0

    def flow(self, li: int, col: int) -> Any:
        self.fli, self.fc = li, col
        return self.flow_node()

    def flow_node(self) -> Any:
        self.fskip()
        ch = self.fpeek()
        if ch == "[":
            return self.flow_seq()
        if ch == "{":
            return self.flow_map()
        if ch in "'\"":
            value, self.fc = self.quoted(self.fli, self.fc)
            return value
        return self.flow_plain()

    def flow_plain(self) -> Any:
        text, start = self.lines[self.fli].text, self.fc
        self.check_plain_start(self.fli, start, flow=True)
        end = k = start
        while k < len(text):
            ch = text[k]
            if ch in ",[]{}" or (ch == ":" and text[k + 1:k + 2] in ("",) + tuple(_FLOW_END)):
                break
            if ch == "#" and text[k - 1] == " ":
                break
            if ch == "?":
                self.fail("'?' inside a flow scalar is not supported", self.fli)
            if ch != " ":
                end = k + 1
            k += 1
        self.fc = end
        return _resolve(text[start:end], self.lines[self.fli].no)

    def flow_seq(self) -> List[Any]:
        self.fc += 1
        out = []
        while True:
            self.fskip()
            if self.fpeek() == "]":
                self.fc += 1
                return out
            out.append(self.flow_node())
            self.fskip()
            ch = self.fpeek()
            if ch == ",":
                self.fc += 1
            elif ch == "]":
                self.fc += 1
                return out
            elif ch == ":":
                self.fail("a single-pair mapping inside a flow sequence is not supported", self.fli)
            else:
                self.fail(f"expected ',' or ']' in a flow sequence, found {ch!r}", self.fli)

    def flow_map(self) -> Dict[Any, Any]:
        self.fc += 1
        out = {}
        while True:
            self.fskip()
            ch = self.fpeek()
            if ch == "}":
                self.fc += 1
                return out
            if ch in "[{":
                self.fail("only plain and quoted scalars can be mapping keys", self.fli)
            if ch == "?" and self.lines[self.fli].text[self.fc + 1:self.fc + 2] in ("", " "):
                self.fail("complex keys ('?') are not supported", self.fli)
            key = self.flow_node()
            self.fskip()
            value = None
            if self.fpeek() == ":":
                self.fc += 1
                self.fskip()
                if self.fpeek() not in ",}":
                    value = self.flow_node()
                    self.fskip()
            out[key] = value
            ch = self.fpeek()
            if ch == ",":
                self.fc += 1
            elif ch == "}":
                self.fc += 1
                return out
            else:
                self.fail(f"expected ',' or '}}' in a flow mapping, found {ch!r}", self.fli)

    def document(self) -> Any:
        if not self.lines:
            return None
        value, li = self.node(0, self.lines[0].indent, -1)
        if li < len(self.lines):
            self.fail("unexpected content after the document's top-level node", li)
        return value


def safe_load(stream) -> Any:
    """The document in ``stream`` (text, UTF-8 bytes, or a file opened for
    reading) as ``yaml.safe_load`` reads it; raises
    :class:`YAMLSubsetError` for anything outside the subset."""
    if hasattr(stream, "read"):
        stream = stream.read()
    if isinstance(stream, bytes):
        stream = stream.decode("utf-8")
    return _Parser(_lines(stream)).document()
