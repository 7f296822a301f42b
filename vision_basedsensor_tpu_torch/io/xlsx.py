"""Minimal .xlsx reader/writer (stdlib only).

A verbatim copy of ``vision_basedsensor_tpu/io/xlsx.py``, kept so that
the port never imports the JAX package: both packages write the same bytes.

The reference exchanges calibration parameters and 3D coordinates through
Excel files (``IntrinsicParameters.xlsx``, ``ExtrinsicParameters.xlsx``,
``marker_3d_coordinates.xlsx`` — ``intrinsic_calibration.py:51``,
``extrinsic_calibration.py:154-156``, ``3d_reconstruction.py:431-432``).
This environment has pandas but no openpyxl engine, so artifact
compatibility is provided by a self-contained implementation of the tiny
subset of OOXML these files use: one worksheet, inline/shared strings, and
numbers.
"""
from __future__ import annotations

import re
import math
import zipfile
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    name = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        name = chr(65 + rem) + name
    return name


def _col_index(ref: str) -> int:
    m = re.match(r"([A-Z]+)", ref)
    i = 0
    for ch in m.group(1):
        i = i * 26 + (ord(ch) - 64)
    return i - 1


def write_xlsx(path: str, rows: list[list]) -> None:
    """Write rows (lists of str/float/int/None) to a single-sheet xlsx."""
    cells = []
    for ri, row in enumerate(rows, start=1):
        parts = []
        for ci, val in enumerate(row):
            ref = f"{_col_name(ci)}{ri}"
            if val is None or (isinstance(val, str) and val == ""):
                continue
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                # Non-finite floats are not valid xlsx numeric cells
                # (<v>nan</v> makes Excel/openpyxl reject the file); write
                # them as inline strings like openpyxl does.
                if isinstance(val, float) and not math.isfinite(val):
                    parts.append(f'<c r="{ref}" t="inlineStr"><is>'
                                 f"<t>{val!r}</t></is></c>")
                else:
                    parts.append(f'<c r="{ref}"><v>{val!r}</v></c>')
            else:
                parts.append(f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">'
                             f"{escape(str(val))}</t></is></c>")
        cells.append(f'<row r="{ri}">' + "".join(parts) + "</row>")
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
             "<sheetData>" + "".join(cells) + "</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def read_xlsx(path: str) -> list[list]:
    """Read the first worksheet into rows of str/float/None."""
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        sheet_names = [n for n in z.namelist()
                       if re.match(r"xl/worksheets/sheet1?\.xml$", n)]
        sheet = sheet_names[0] if sheet_names else "xl/worksheets/sheet1.xml"
        root = ET.fromstring(z.read(sheet))

    rows: list[list] = []
    for row_el in root.iter(f"{_NS}row"):
        row: list = []
        for c in row_el.findall(f"{_NS}c"):
            ref = c.get("r", "")
            ci = _col_index(ref) if ref else len(row)
            while len(row) < ci:
                row.append(None)
            t = c.get("t")
            v = c.find(f"{_NS}v")
            is_el = c.find(f"{_NS}is")
            if t == "inlineStr" and is_el is not None:
                row.append("".join(e.text or "" for e in is_el.iter(f"{_NS}t")))
            elif t == "s" and v is not None:
                row.append(shared[int(v.text)])
            elif v is not None and v.text is not None:
                try:
                    row.append(float(v.text))
                except ValueError:
                    row.append(v.text)
            else:
                row.append(None)
        rows.append(row)
    width = max((len(r) for r in rows), default=0)
    return [r + [None] * (width - len(r)) for r in rows]
