"""The subset of Jinja2 the workflow generator's template uses, on the
standard library.

The port carries no jinja2 (the card's machine has none). The manifest
template (``workflow/templates/tpu-workflow.yaml.j2``) uses a small part
of the language, and this module renders that part with Jinja2's
semantics under the generator's settings (``StrictUndefined``,
``keep_trailing_newline=True``, no autoescape, no ``trim_blocks`` or
``lstrip_blocks``), so the port's manifests are the JAX generator's bytes:

- ``{{ expr }}`` prints ``str(value)``; ``expr`` is a dotted name
  (``gang.gang_id``: an attribute, else an item, as Jinja looks them up)
  followed by filters: ``length``, ``indent(width, first, blank)`` (the
  first line left alone) and ``tojson(indent)`` (``json.dumps`` with
  sorted keys, ``<``, ``>``, ``&`` and ``'`` escaped as ``\\u003c``,
  ``\\u003e``, ``\\u0026`` and ``\\u0027``);
- ``{% for name in expr %}`` .. ``{% endfor %}`` and ``{% if expr %}`` ..
  ``{% endif %}`` (Python's truth);
- ``{# comments #}``;
- a ``-`` inside a delimiter (``{%-``, ``-%}``, ``{{-``, ``-}}``) strips
  every whitespace character on that side, newlines included.

A name or attribute the context lacks raises :class:`UndefinedError`, as
``StrictUndefined`` does. Anything outside the subset raises
:class:`TemplateSyntaxError` when the template is parsed.
"""

import json
import re
from typing import Any, Dict, List, Tuple

__all__ = ["Template", "TemplateSyntaxError", "UndefinedError", "render"]

_TAG = re.compile(r"(\{\{-?|\{%-?|\{#-?)(.*?)(-?\}\}|-?%\}|-?#\})", re.S)
_CLOSE = {"{{": "}}", "{%": "%}", "{#": "#}"}
_NAME = r"[A-Za-z_][A-Za-z0-9_]*"
_DOTTED = re.compile(rf"^{_NAME}(?:\.{_NAME})*$")
_FILTER = re.compile(rf"^({_NAME})(?:\((.*)\))?$", re.S)
_FOR = re.compile(rf"^for\s+({_NAME})\s+in\s+(.+)$", re.S)


class TemplateSyntaxError(ValueError):
    """The template uses something outside the subset, or is malformed."""


class UndefinedError(KeyError):
    """A name or attribute the context does not define (``StrictUndefined``)."""

    def __str__(self) -> str:
        return str(self.args[0]) if self.args else ""


def _indent(s, width=4, first=False, blank=False) -> str:
    """Jinja's ``indent`` filter."""
    indention = width if isinstance(width, str) else " " * width
    newline = "\n"
    s = str(s) + newline  # Jinja's quirk for splitlines
    if blank:
        rv = (newline + indention).join(s.splitlines())
    else:
        lines = s.splitlines()
        rv = lines.pop(0)
        if lines:
            rv += newline + newline.join(indention + line if line else line for line in lines)
    if first:
        rv = indention + rv
    return rv


def _tojson(value, indent=None) -> str:
    """Jinja's ``tojson`` filter (``htmlsafe_json_dumps`` with the
    default policy, ``sort_keys=True``)."""
    kwargs: Dict[str, Any] = {"sort_keys": True}
    if indent is not None:
        kwargs["indent"] = indent
    return (json.dumps(value, **kwargs).replace("<", "\\u003c").replace(">", "\\u003e")
            .replace("&", "\\u0026").replace("'", "\\u0027"))


_FILTERS = {"length": len, "indent": _indent, "tojson": _tojson}


def _literal(raw: str):
    """One filter argument: an integer, ``true`` or ``false``."""
    raw = raw.strip()
    if re.fullmatch(r"-?\d+", raw):
        return int(raw)
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    raise TemplateSyntaxError(f"filter argument {raw!r} is not an integer or a boolean")


class _Expr:
    """A dotted name and its filters, parsed once."""

    __slots__ = ("path", "filters")

    def __init__(self, source: str):
        parts = [p.strip() for p in source.strip().split("|")]
        if not _DOTTED.match(parts[0]):
            raise TemplateSyntaxError(f"expression {source.strip()!r}: only dotted names and filters are supported")
        self.path = parts[0].split(".")
        self.filters: List[Tuple[str, list]] = []
        for part in parts[1:]:
            m = _FILTER.match(part)
            if not m or m.group(1) not in _FILTERS:
                raise TemplateSyntaxError(f"filter {part!r} is not supported (supported: {sorted(_FILTERS)})")
            args = [_literal(a) for a in m.group(2).split(",")] if m.group(2) and m.group(2).strip() else []
            self.filters.append((m.group(1), args))

    def evaluate(self, context: Dict[str, Any]):
        head = self.path[0]
        if head not in context:
            raise UndefinedError(f"'{head}' is undefined")
        value = context[head]
        for attr in self.path[1:]:
            value = _getattr(value, attr)
        for name, args in self.filters:
            value = _FILTERS[name](value, *args)
        return value


def _getattr(obj, attr: str):
    """Jinja's ``environment.getattr``: the attribute, else the item."""
    try:
        return getattr(obj, attr)
    except AttributeError:
        pass
    try:
        return obj[attr]
    except (TypeError, LookupError):
        raise UndefinedError(f"{type(obj).__name__!r} object has no attribute {attr!r}") from None


def _lex(source: str) -> List[tuple]:
    """Text and tags in order, whitespace control applied to the text."""
    source = source.replace("\r\n", "\n").replace("\r", "\n")
    tokens: List[list] = []
    pos = 0
    strip_next = False
    for m in _TAG.finditer(source):
        opener, body, closer = m.group(1), m.group(2), m.group(3)
        if _CLOSE[opener.rstrip("-")] != closer.lstrip("-"):
            raise TemplateSyntaxError(f"tag {m.group(0)!r} opens with {opener!r} and closes with {closer!r}")
        text = source[pos:m.start()]
        if strip_next:
            text = text.lstrip()
        if opener.endswith("-"):
            text = text.rstrip()
        tokens.append(["text", text])
        strip_next = closer.startswith("-")
        if opener.startswith("{{"):
            tokens.append(["out", body])
        elif opener.startswith("{%"):
            tokens.append(["stmt", body.strip()])
        pos = m.end()
    text = source[pos:]
    tokens.append(["text", text.lstrip() if strip_next else text])
    return [tuple(t) for t in tokens if not (t[0] == "text" and not t[1])]


def _parse(tokens: List[tuple], i: int, ends: Tuple[str, ...]) -> Tuple[list, int, str]:
    """Nodes up to one of ``ends``; returns (nodes, next index, the end met)."""
    nodes: list = []
    while i < len(tokens):
        kind, value = tokens[i]
        i += 1
        if kind == "text":
            nodes.append(("text", value))
        elif kind == "out":
            nodes.append(("out", _Expr(value)))
        elif value in ends:
            return nodes, i, value
        elif value.startswith("for ") or value == "for":
            m = _FOR.match(value)
            if not m:
                raise TemplateSyntaxError(f"malformed for statement {{% {value} %}}")
            body, i, _ = _parse(tokens, i, ("endfor",))
            nodes.append(("for", m.group(1), _Expr(m.group(2)), body))
        elif value.startswith("if "):
            body, i, _ = _parse(tokens, i, ("endif",))
            nodes.append(("if", _Expr(value[3:]), body))
        else:
            raise TemplateSyntaxError(f"statement {{% {value} %}} is not supported here")
    if ends:
        raise TemplateSyntaxError(f"unexpected end of template: expected one of {list(ends)}")
    return nodes, i, ""


def _render(nodes: list, context: Dict[str, Any], out: List[str]) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "out":
            out.append(str(node[1].evaluate(context)))
        elif kind == "for":
            _, name, expr, body = node
            for item in expr.evaluate(context):
                _render(body, dict(context, **{name: item}), out)
        elif node[1].evaluate(context):
            _render(node[2], context, out)


class Template:
    """A parsed template; :meth:`render` takes the context as keywords."""

    def __init__(self, source: str):
        self.nodes, _, _ = _parse(_lex(source), 0, ())

    def render(self, **context: Any) -> str:
        out: List[str] = []
        _render(self.nodes, context, out)
        return "".join(out)


def render(source: str, **context: Any) -> str:
    return Template(source).render(**context)
