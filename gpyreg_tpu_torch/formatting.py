"""Inspectable-object representation helpers.

Port of ``gpyreg_tpu/formatting.py`` (the whole module; it imports no
JAX, and the port keeps its own copy): ``summarize``, ``format_dict``,
``get_repr`` and ``full_repr``, the reference formatting.py's surface, a
small render dispatcher keyed on value type that backs ``GP.__repr__``.
"""

from textwrap import indent

import numpy as np

_INDENT = "    "


def _render(val, expand=False, full=False, arr_size_thresh=10, precision=4):
    """Render one value according to its type."""
    if isinstance(val, np.ndarray):
        return summarize(val, arr_size_thresh, precision)
    if isinstance(val, dict) and type(val) is dict:
        if expand:
            return format_dict(
                val, arr_size_thresh=arr_size_thresh, precision=precision
            )
        return object.__repr__(val)
    if expand:
        # Objects participating in the protocol render recursively.
        try:
            return val.__repr__(expand=True, full=full)
        except TypeError:
            pass
    elif hasattr(val, "_short_repr"):
        return val._short_repr()
    return repr(val)


def summarize(obj, arr_size_thresh=10, precision=4):
    """One-line value summary: small ndarrays print their contents,
    large ones their shape and type; everything else its repr."""
    if not isinstance(obj, np.ndarray):
        return _render(obj)
    if obj.size >= arr_size_thresh:
        return f"{obj.shape} {type(obj).__name__}"
    text = np.array2string(
        obj, precision=precision, suppress_small=True, separator=", "
    )
    if "\n" in text:
        text = indent("\n" + text, _INDENT)
    return f"{text} : {type(obj).__name__}"


def format_dict(d, **kwargs):
    """Multi-line dict rendering with summarized values."""
    if d is None:
        return "None"
    lines = []
    for key, val in d.items():
        shown_key = repr(key) if isinstance(key, str) else str(key)
        if type(val) is dict:
            lines.append(f"{shown_key}: {format_dict(val, **kwargs)},")
        else:
            lines.append(f"{shown_key}: {summarize(val, **kwargs)},")
    return "{\n" + indent("\n".join(lines) + "\n", _INDENT) + "}"


def get_repr(obj, expand=False, full=False, **kwargs):
    """Representation of a single value; ``expand`` recurses into dicts
    and protocol-aware objects instead of using their short form."""
    return _render(obj, expand=expand, full=full, **kwargs)


def full_repr(obj, title, order=None, exclude=None, **kwargs):
    """Multi-line attribute dump of ``obj``: the ``order`` attributes
    first (dotted paths allowed), then the rest of ``__dict__`` sorted,
    minus ``exclude``."""
    order = list(order or ())
    exclude = set(exclude or ())

    def lookup(path):
        target = obj
        for part in path.split("."):
            target = getattr(target, part, None)
        return target

    lines = [f"self.{key} = {get_repr(lookup(key), **kwargs)}" for key in order]

    attrs = getattr(obj, "__dict__", {})
    try:
        remaining = sorted(attrs)
    except TypeError:
        remaining = list(attrs)
    lines.extend(
        f"self.{key} = {get_repr(attrs[key], **kwargs)}"
        for key in remaining
        if key not in order and key not in exclude
    )
    return title + ":\n" + indent(",\n".join(lines), _INDENT)
