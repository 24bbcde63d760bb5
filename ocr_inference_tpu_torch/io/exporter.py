"""Result exporters: plain text, PageXML (Transkribus-compatible), JSONL.

Copy of ocr_inference_tpu/io/exporter.py on the port's geometry helpers;
byte-compatible with the reference exporters (reference:
BDRC/exporter.py): same PcGts 2013-07-15 namespace and attribute set, same
line ids (``line_9874_{i}``), same readingOrder custom attrs, same minidom
pretty-printing, same un-rotation of contours before writing.
"""

from __future__ import annotations

import abc
import json
import logging
import xml.etree.ElementTree as etree
from datetime import datetime
from typing import List, Optional

import numpy as np

from ocr_inference_tpu_torch.core.data import BBox, Line, OCRLine
from ocr_inference_tpu_torch.geometry import (
    get_text_bbox,
    optimize_contour,
    rotate_contour,
)


def get_utc_time() -> str:
    """Timestamp format parity (reference: BDRC/utils.py:92-102 — local time
    formatted as ISO, despite the name)."""
    return datetime.now().strftime("%Y-%m-%dT%H:%M:%S")


class Exporter(abc.ABC):
    """Base exporter (reference: BDRC/exporter.py:24-113)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        logging.info("Init Exporter")

    @abc.abstractmethod
    def export_lines(
        self,
        image: Optional[np.ndarray],
        image_name: str,
        lines: List[Line],
        text_lines: List[OCRLine],
    ):
        raise NotImplementedError

    @staticmethod
    def get_bbox(bbox: BBox) -> tuple[int, int, int, int]:
        return bbox.x, bbox.y, bbox.w, bbox.h

    @staticmethod
    def get_text_points(contour) -> str:
        """"x,y x,y ..." with a trailing space (reference: exporter.py:81-96)."""
        points = ""
        for box in contour:
            points += f"{box[0][0]},{box[0][1]} "
        return points

    @staticmethod
    def get_bbox_points(bbox: BBox) -> str:
        return (
            f"{bbox.x},{bbox.y} {bbox.x + bbox.w},{bbox.y} "
            f"{bbox.x + bbox.w},{bbox.y + bbox.h} {bbox.x},{bbox.y + bbox.h}"
        )


def _xml_text(s: str) -> str:
    """minidom text-node escaping (&, <, > only)."""
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _xml_attr(s: str) -> str:
    """minidom attribute-value escaping (text escapes plus double quotes)."""
    return _xml_text(s).replace('"', "&quot;")


# The PcGts byte contract, as one golden template. Transkribus and the BDRC
# tooling consume these files verbatim, so the namespace URIs, the magic
# region/line ids ("region_main", "line_9874_<i>", "1234_0"), the
# Creator string, and minidom-toprettyxml's tab indentation are all part of
# the on-disk format (reference: BDRC/exporter.py:162-233; byte equality
# with the JAX exporters' files is pinned by tests/test_torch_exporter.py).
_PAGE_XML_TEMPLATE = """<?xml version="1.0" ?>
<PcGts xmlns="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15" xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" xsi:schemaLocation="http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15 http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15/pagecontent.xsd">
\t<Metadata>
\t\t<Creator>Transkribus</Creator>
\t\t<Created>{created}</Created>
\t</Metadata>
\t<Page imageFilename="{image_name}" imageWidth="{width}" imageHeight="{height}">
\t\t<ReadingOrder>
\t\t\t<OrderedGroup id="1234_0" caption="Regions reading order"/>
\t\t\t<RegionRefIndexed index="0" regionRef="region_main"/>
\t\t</ReadingOrder>
\t\t<TextRegion id="region_main" custom="readingOrder {{index:0;}}">
\t\t\t<Coords points="{text_bbox}"/>
{text_lines}\t\t</TextRegion>
\t</Page>
</PcGts>
"""

_TEXT_LINE_TEMPLATE = """\t\t\t<TextLine id="line_9874_{index}" custom="readingOrder {{index: {index};}}">
\t\t\t\t<Coords points="{points}"/>
\t\t\t\t<TextEquiv>
\t\t\t\t\t{unicode}
\t\t\t\t</TextEquiv>
\t\t\t</TextLine>
"""


class PageXMLExporter(Exporter):
    """PageXML writer (reference: BDRC/exporter.py:116-276).

    The document is rendered from the golden templates above rather than
    rebuilt element by element — the byte contract IS the format, so the
    template states it directly."""

    def get_text_line_block(
        self, coordinate: str, index: int, unicode_text: str
    ) -> str:
        unicode_el = (
            f"<Unicode>{_xml_text(unicode_text)}</Unicode>"
            if unicode_text
            else "<Unicode/>"
        )
        return _TEXT_LINE_TEMPLATE.format(
            index=index, points=_xml_attr(coordinate), unicode=unicode_el
        )

    def build_xml_document(
        self,
        image: np.ndarray,
        image_name: str,
        text_bbox: str,
        lines: List[str],
        text_lines: Optional[List[OCRLine]],
    ) -> str:
        blocks = [
            self.get_text_line_block(
                coordinate=line,
                index=l_idx,
                unicode_text=(
                    text_lines[l_idx].text if text_lines else ""
                ),
            )
            for l_idx, line in enumerate(lines)
        ]
        return _PAGE_XML_TEMPLATE.format(
            created=_xml_text(get_utc_time()),
            image_name=_xml_attr(image_name),
            width=image.shape[1],
            height=image.shape[0],
            text_bbox=_xml_attr(text_bbox),
            text_lines="".join(blocks),
        )

    def export_lines(
        self,
        image: Optional[np.ndarray],
        image_name: str,
        lines: List[Line],
        text_lines: List[OCRLine],
        optimize: bool = True,
        bbox: bool = False,
        angle: float = 0.0,
    ):
        if angle != abs(0):
            x_center = image.shape[1] // 2
            y_center = image.shape[0] // 2
            for line in lines:
                line.contour = rotate_contour(
                    line.contour, (x_center, y_center), angle
                )
        if optimize:
            for line in lines:
                line.contour = optimize_contour(line.contour)

        if bbox:
            plain_lines = [str(self.get_bbox(x.bbox)) for x in lines]
        else:
            plain_lines = [self.get_text_points(x.contour) for x in lines]

        text_bbox = get_text_bbox(lines)
        plain_box = self.get_bbox_points(text_bbox)

        xml_doc = self.build_xml_document(
            image,
            image_name,
            text_bbox=plain_box,
            lines=plain_lines,
            text_lines=text_lines,
        )
        out_file = f"{self.output_dir}/{image_name}.xml"
        with open(out_file, "w", encoding="UTF-8") as f:
            f.write(xml_doc)
        return out_file


class TextExporter(Exporter):
    """Plain text writer, one line per row
    (reference: BDRC/exporter.py:279-334)."""

    def export_lines(
        self,
        image: Optional[np.ndarray],
        image_name: str,
        lines: List[Line],
        text_lines: List[OCRLine],
        **_: object,
    ):
        out_file = f"{self.output_dir}/{image_name}.txt"
        with open(out_file, "w", encoding="UTF-8") as f:
            for line in text_lines:
                f.write(f"{line.text}\n")
        return out_file

    def export_text(self, image_name: str, text_lines: List[OCRLine]):
        return self.export_lines(None, image_name, [], text_lines)


class JsonExporter(Exporter):
    """Single-record .jsonl writer (reference: BDRC/exporter.py:337-407)."""

    def export_lines(
        self,
        image: Optional[np.ndarray],
        image_name: str,
        lines: List[Line],
        text_lines: List[OCRLine],
        optimize: bool = True,
        bbox: bool = False,
        angle: float = 0.0,
    ):
        if angle != abs(0):
            x_center = image.shape[1] // 2
            y_center = image.shape[0] // 2
            for line in lines:
                line.contour = rotate_contour(
                    line.contour, (x_center, y_center), angle
                )
        if optimize:
            for line in lines:
                line.contour = optimize_contour(line.contour)

        if bbox:
            plain_lines = [self.get_bbox(x.bbox) for x in lines]
        else:
            plain_lines = [self.get_text_points(x.contour) for x in lines]

        text_bbox = get_text_bbox(lines)
        plain_box = self.get_bbox_points(text_bbox)
        json_record = {
            "image": image_name,
            "textbox": plain_box,
            "lines": plain_lines,
            "text": [x.text for x in text_lines],
        }
        out_file = f"{self.output_dir}/{image_name}.jsonl"
        with open(out_file, "w", encoding="UTF-8") as f:
            json.dump(json_record, f, ensure_ascii=False, indent=1)
        return out_file
