"""Minimal multipart/form-data parser (stdlib-only).

Python 3.13 removed ``cgi``; FastAPI isn't a baked dependency here.  This
covers the subset the /enhance contract needs: file fields (bytes +
content-type) and plain form fields.

Hardening contract (fuzz-tested in tests/test_multipart_fuzz.py): any
malformed framing raises ``ValueError`` — never another exception type,
never a silent part drop — and the server front end maps that to HTTP 400
(the reference delegates this to FastAPI/python-multipart, app.py:26; a
first-party parser must earn the same trust).  Specifically:

* bare-LF framing is SUPPORTED: header blocks terminated by ``\\n\\n`` and
  header lines separated by ``\\n`` parse identically to CRLF (lenient per
  RFC 2046 §4.1.1's "CRLF" being widely violated by hand-rolled clients);
* a part with headers but NO blank-line terminator is a loud ValueError,
  not a skip (the round-4 review's silent-drop finding);
* the terminal ``--boundary--`` is REQUIRED: a truncated body fails the
  parse instead of delivering a truncated file part downstream;
* header bytes decode as latin-1 (never raises); boundary length is
  bounded (RFC 2046 §5.1.1 caps it at 70; we allow 200 before rejecting);
* RFC-sanctioned leniency stays: preamble before the first boundary and
  epilogue after the terminal one are ignored.
"""

from __future__ import annotations

from typing import Dict, Optional

_MAX_BOUNDARY = 200


class Part:
    def __init__(self, name: str, data: bytes, filename: Optional[str],
                 content_type: Optional[str]):
        self.name = name
        self.data = data
        self.filename = filename
        self.content_type = content_type


def _strip_framing(chunk: bytes) -> bytes:
    """Remove exactly one line terminator after the boundary line and one
    before the next boundary — a blanket strip would eat payload bytes of
    binary files ending in 0x0d/0x0a."""
    if chunk.startswith(b"\r\n"):
        chunk = chunk[2:]
    elif chunk.startswith(b"\n"):
        chunk = chunk[1:]
    if chunk.endswith(b"\r\n"):
        chunk = chunk[:-2]
    elif chunk.endswith(b"\n"):
        chunk = chunk[:-1]
    return chunk


def _split_headers(chunk: bytes):
    """(header_blob, data) at the first blank line, CRLF or bare LF."""
    i_crlf = chunk.find(b"\r\n\r\n")
    i_lf = chunk.find(b"\n\n")
    if i_crlf < 0 and i_lf < 0:
        raise ValueError("multipart part missing blank line after headers")
    # take whichever terminator starts first (they can never start at the
    # same index — the first byte differs), so mixed-framing bodies split
    # at the earliest blank line of either flavor
    if i_crlf >= 0 and (i_lf < 0 or i_crlf <= i_lf):
        return chunk[:i_crlf], chunk[i_crlf + 4:]
    return chunk[:i_lf], chunk[i_lf + 2:]


def parse_multipart(body: bytes, content_type_header: str) -> Dict[str, Part]:
    """Returns {field_name: Part}.  Raises ValueError on malformed input."""
    boundary = None
    for piece in content_type_header.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip().strip('"')
            break
    if not boundary:
        raise ValueError("missing multipart boundary")
    if len(boundary) > _MAX_BOUNDARY:
        raise ValueError("multipart boundary too long")
    delim = b"--" + boundary.encode("latin-1", "replace")
    chunks = body.split(delim)
    if len(chunks) < 2:
        raise ValueError("multipart boundary never appears in body")
    parts: Dict[str, Part] = {}
    terminated = False
    for chunk in chunks[1:]:  # chunks[0] is the RFC 2046 preamble: ignored
        if chunk.startswith(b"--"):
            # a REAL terminal delimiter is "--boundary--" followed only by
            # optional linear whitespace and then CRLF + epilogue (RFC 2046
            # §5.1.1).  "--garbage" here means a part's DATA contained the
            # delimiter bytes — reject loudly rather than silently dropping
            # every later part (the hardening contract above).
            head = chunk.split(b"\r\n", 1)[0].split(b"\n", 1)[0]
            if head.strip(b" \t") != b"--":
                raise ValueError(
                    "boundary delimiter appears inside part data")
            terminated = True
            break  # everything after the terminal delimiter is epilogue
        chunk = _strip_framing(chunk)
        header_blob, data = _split_headers(chunk)
        headers = {}
        for line in header_blob.split(b"\n"):
            line = line.rstrip(b"\r")
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.decode("latin-1").strip().lower()] = \
                    v.decode("latin-1").strip()
        disp = headers.get("content-disposition", "")
        name, filename = None, None
        for item in disp.split(";"):
            item = item.strip()
            if item.startswith("name="):
                name = item[5:].strip('"')
            elif item.startswith("filename="):
                filename = item[9:].strip('"')
        if name is None:
            raise ValueError(
                "multipart part missing content-disposition name")
        parts[name] = Part(name, data, filename, headers.get("content-type"))
    if not terminated:
        raise ValueError("missing terminal multipart boundary (truncated "
                         "body?)")
    return parts
