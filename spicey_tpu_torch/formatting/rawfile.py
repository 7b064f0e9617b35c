"""ngspice rawfile writer — interop beyond the reference.

The reference exports results as text tables and tscircuit circuit-json
graphs (lib/formatting/*). Real SPICE tooling (gwave, spyci, PyLTSpice,
KiCad's simulator UI) speaks the ngspice/SPICE3 "rawfile" format instead;
this module writes it so the engine's output plugs into that ecosystem.
A copy of spicey_tpu/formatting/rawfile.py; a result without a title
keeps that package's "spicey_tpu" title, so both write the same bytes.

Format (ngspice manual §"rawfile"): per-plot header lines
(Title/Date/Plotname/Flags/No. Variables/No. Points), a Variables: block
of ``index name type`` rows, then either an ASCII ``Values:`` block
(point index + one value per line, complex as ``re,im``) or a ``Binary:``
block of float64 little-endian (complex = re,im pairs). Multiple plots
concatenate in one file, exactly how ngspice writes ``write all``.
"""

from __future__ import annotations

import io
from datetime import datetime, timezone

import numpy as np


def _plot(title: str, plotname: str, date: str, names: list[str],
          types: list[str], columns: list[np.ndarray], is_complex: bool,
          ascii_values: bool) -> tuple[str, bytes]:
    n_vars = len(names)
    n_points = len(columns[0]) if columns else 0
    head = io.StringIO()
    head.write(f"Title: {title}\n")
    head.write(f"Date: {date}\n")
    head.write(f"Plotname: {plotname}\n")
    head.write(f"Flags: {'complex' if is_complex else 'real'}\n")
    head.write(f"No. Variables: {n_vars}\n")
    head.write(f"No. Points: {n_points}\n")
    head.write("Variables:\n")
    for k, (nm, ty) in enumerate(zip(names, types)):
        extra = "\tgrid=3" if (k == 0 and is_complex) else ""
        head.write(f"\t{k}\t{nm}\t{ty}{extra}\n")
    if ascii_values:
        head.write("Values:\n")
        for p in range(n_points):
            for k in range(n_vars):
                v = columns[k][p]
                lead = f"{p}\t" if k == 0 else "\t"
                if is_complex:
                    c = complex(v)
                    head.write(f"{lead}{c.real:.15e},{c.imag:.15e}\n")
                else:
                    head.write(f"{lead}{float(v.real):.15e}\n")
        return head.getvalue(), b""
    head.write("Binary:\n")
    # point-major interleave: var0[p], var1[p], ... as f64 LE
    # (complex plots write re,im pairs per value)
    mat = np.stack([np.asarray(c) for c in columns], axis=1)  # (P, V)
    if is_complex:
        buf = np.empty((n_points, n_vars, 2), dtype="<f8")
        buf[..., 0] = mat.real
        buf[..., 1] = mat.imag
    else:
        buf = mat.real.astype("<f8")
    return head.getvalue(), buf.tobytes()


def _source_branch_vars(element_currents: dict,
                        v_names: list[str]) -> list[str]:
    """ngspice exposes V-source branch currents as <name>#branch."""
    vset = {n.lower() for n in v_names}
    return [n for n in element_currents if n.lower() in vset]


def format_rawfile(result: object, title: str | None = None,
                   ascii_values: bool = True,
                   date: str | None = None) -> bytes:
    """Serialize a SimulationResult (or a bare ACResult/TranResult) into
    ngspice rawfile bytes — one plot per analysis that ran, AC first
    (ngspice's ``write`` order for ``.ac``+``.tran`` decks).

    ``ascii_values=False`` writes Binary: blocks (float64 LE), the format
    most viewers default to. Returns bytes either way so callers can
    ``open(path, "wb").write(...)`` without branching.
    """
    circuit = getattr(result, "circuit", None)
    if title is None:
        title = (getattr(circuit, "title", None) or "spicey_tpu") \
            if circuit is not None else "spicey_tpu"
    if date is None:
        date = datetime.now(timezone.utc).strftime("%a %b %d %H:%M:%S %Y")
    v_names = tuple(v.name for v in circuit.V) if circuit is not None else ()

    ac = getattr(result, "ac", None) or (
        result if type(result).__name__ == "ACResult" else None)
    tran = getattr(result, "tran", None) or (
        result if type(result).__name__ == "TranResult" else None)
    op = getattr(result, "op", None)
    dc = getattr(result, "dc", None)

    out = io.BytesIO()
    if op is not None:
        # ngspice writes the op as a one-point real plot
        names = []
        types = []
        cols: list[np.ndarray] = []
        for node, val in op.node_voltages.items():
            names.append(f"v({node})")
            types.append("voltage")
            cols.append(np.asarray([val], np.float64))
        for el in _source_branch_vars(op.element_currents, v_names):
            names.append(f"{el}#branch")
            types.append("current")
            cols.append(np.asarray([op.element_currents[el]], np.float64))
        head, body = _plot(title, "Operating Point", date, names, types,
                           cols, is_complex=False,
                           ascii_values=ascii_values)
        out.write(head.encode())
        out.write(body)
    if dc is not None:
        names = ["v(v-sweep)"]
        types = ["voltage"]
        cols = [np.asarray(dc.sweep, np.float64)]
        for node, series in dc.node_voltages.items():
            names.append(f"v({node})")
            types.append("voltage")
            cols.append(np.asarray(series, np.float64))
        head, body = _plot(title, "DC transfer characteristic", date,
                           names, types, cols, is_complex=False,
                           ascii_values=ascii_values)
        out.write(head.encode())
        out.write(body)
    if ac is not None:
        names = ["frequency"]
        types = ["frequency"]
        cols: list[np.ndarray] = [np.asarray(ac.freqs, np.complex128)]
        for node, series in ac.node_voltages.items():
            names.append(f"v({node})")
            types.append("voltage")
            cols.append(np.asarray(series, np.complex128))
        for el in _source_branch_vars(ac.element_currents, v_names):
            names.append(f"{el}#branch")
            types.append("current")
            cols.append(np.asarray(ac.element_currents[el], np.complex128))
        head, body = _plot(title, "AC Analysis", date, names, types, cols,
                           is_complex=True, ascii_values=ascii_values)
        out.write(head.encode())
        out.write(body)
    if tran is not None:
        names = ["time"]
        types = ["time"]
        cols = [np.asarray(tran.times, np.float64)]
        for node, series in tran.node_voltages.items():
            names.append(f"v({node})")
            types.append("voltage")
            cols.append(np.asarray(series, np.float64))
        for el in _source_branch_vars(tran.element_currents, v_names):
            names.append(f"{el}#branch")
            types.append("current")
            cols.append(np.asarray(tran.element_currents[el], np.float64))
        head, body = _plot(title, "Transient Analysis", date, names, types,
                           cols, is_complex=False, ascii_values=ascii_values)
        out.write(head.encode())
        out.write(body)
    return out.getvalue()


def write_rawfile(result: object, path: str, **kw: object) -> None:
    """format_rawfile straight to a file (bytes mode handles both forms)."""
    with open(path, "wb") as fh:
        fh.write(format_rawfile(result, **kw))


def read_rawfile(data: bytes) -> list[tuple[str, dict]]:
    """Parse rawfile bytes back into [(plotname, {var: np.ndarray})...].

    Round-trip check for the writer and a convenience for comparing against
    real ngspice output files. Handles ASCII and binary plots.
    """
    plots = []
    pos = 0
    while True:
        idx = data.find(b"Title:", pos)
        if idx < 0:
            break
        # header is line-oriented ASCII up to Values:/Binary:
        hdr_end = data.find(b"Values:", idx)
        bin_end = data.find(b"Binary:", idx)
        if hdr_end < 0 or (0 <= bin_end < hdr_end):
            hdr_end, is_ascii = bin_end, False
        else:
            is_ascii = True
        header = data[idx:hdr_end].decode()
        fields = {}
        var_rows = []
        in_vars = False
        for line in header.splitlines():
            if line.startswith("Variables:"):
                in_vars = True
                continue
            if in_vars and line.startswith("\t"):
                parts = line.strip().split("\t")
                var_rows.append(parts[1])
                continue
            in_vars = False
            if ":" in line:
                k, v = line.split(":", 1)
                fields[k.strip()] = v.strip()
        n_vars = int(fields["No. Variables"])
        n_pts = int(fields["No. Points"])
        is_complex = "complex" in fields.get("Flags", "")
        plotname = fields.get("Plotname", "")
        if is_ascii:
            body_start = hdr_end + len(b"Values:\n")
            vals = np.zeros((n_pts, n_vars), np.complex128)
            text_pos = body_start
            count = 0
            while count < n_pts * n_vars:
                nl = data.find(b"\n", text_pos)
                tok = data[text_pos:nl].decode().strip()
                text_pos = nl + 1
                if not tok:
                    continue
                tok = tok.split("\t")[-1]
                p, k = divmod(count, n_vars)
                if "," in tok:
                    re_s, im_s = tok.split(",")
                    vals[p, k] = float(re_s) + 1j * float(im_s)
                else:
                    vals[p, k] = float(tok)
                count += 1
            pos = text_pos
        else:
            body_start = hdr_end + len(b"Binary:\n")
            per = 2 if is_complex else 1
            nbytes = n_pts * n_vars * per * 8
            raw = np.frombuffer(data[body_start:body_start + nbytes], "<f8")
            if is_complex:
                raw = raw.reshape(n_pts, n_vars, 2)
                vals = raw[..., 0] + 1j * raw[..., 1]
            else:
                vals = raw.reshape(n_pts, n_vars).astype(np.complex128)
            pos = body_start + nbytes
        series = {name: (vals[:, k] if is_complex
                         else vals[:, k].real)
                  for k, name in enumerate(var_rows)}
        plots.append((plotname, series))
    return plots
