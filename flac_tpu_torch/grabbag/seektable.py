"""Seektable specification parsing — the analog of
grabbag__seektable_convert_specification_to_template
(src/share/grabbag/seektable.c:54) and the seektable template helpers in
src/libFLAC/metadata_object.c:1047-1151.

Spec grammar (the `flac -S` option, may be given multiple times joined by
';'):  "X"        → one placeholder point
       "<n>x"     → n evenly spaced points over the whole stream
       "<n.n>s"   → a point every n seconds (+ the initial point at 0)
       "<n>"      → a point at sample number n
"""

from __future__ import annotations

from flac_tpu_torch.metadata import SeekPoint

PLACEHOLDER = SeekPoint.PLACEHOLDER


def _append_spaced_points(points: list[SeekPoint], num: int, total_samples: int) -> None:
    # metadata_object.c:1083: sample_number = total * j / num
    for j in range(num):
        points.append(SeekPoint(total_samples * j // num, 0, 0))


def _append_spaced_points_by_samples(points: list[SeekPoint], samples: int,
                                     total_samples: int) -> None:
    # metadata_object.c:1108: 1 + total/samples points from 0, minus one when
    # the spacing divides the total exactly (no point at sample `total`)
    num = 1 + total_samples // samples
    if total_samples % samples == 0:
        num -= 1
    for j in range(num):
        points.append(SeekPoint(j * samples, 0, 0))


def seektable_template_sort(points: list[SeekPoint], compact: bool = True) -> list[SeekPoint]:
    """FLAC__format_seektable_sort semantics: ascending by sample number,
    placeholders last; `compact` drops duplicate sample numbers."""
    real = sorted((p for p in points if not p.is_placeholder),
                  key=lambda p: p.sample_number)
    placeholders = [p for p in points if p.is_placeholder]
    if compact:
        out: list[SeekPoint] = []
        for p in real:
            if out and out[-1].sample_number == p.sample_number:
                out[-1] = p
            else:
                out.append(p)
        real = out
    return real + placeholders


def seektable_from_specification(spec: str, total_samples: int, sample_rate: int,
                                 only_explicit_placeholders: bool = False,
                                 ) -> tuple[list[SeekPoint], bool]:
    """Returns (template points, spec_has_real_points). Elements that need
    the total sample count are skipped when it is unknown (0), exactly as the
    reference does (seektable.c:76-101)."""
    points: list[SeekPoint] = []
    has_real = False
    for elem in spec.split(";"):
        elem = elem.strip()
        if not elem:
            continue
        if elem == "X":
            points.append(SeekPoint(PLACEHOLDER, 0, 0))
        elif elem.endswith("x"):
            if total_samples > 0:
                has_real = True
                if not only_explicit_placeholders:
                    try:
                        n = int(elem[:-1])
                    except ValueError:
                        continue
                    if n > 0:
                        _append_spaced_points(points, n, total_samples)
        elif elem.endswith("s"):
            if total_samples > 0:
                has_real = True
                if not only_explicit_placeholders:
                    try:
                        sec = float(elem[:-1])
                    except ValueError:
                        continue
                    if sec > 0.0:
                        samples = int(sec * sample_rate)
                        if samples > 0:
                            _append_spaced_points_by_samples(points, samples, total_samples)
        else:
            has_real = True
            if not only_explicit_placeholders:
                try:
                    n = int(elem)
                except ValueError:
                    continue
                if n >= 0 and (total_samples == 0 or n < total_samples):
                    points.append(SeekPoint(n, 0, 0))
    return seektable_template_sort(points, compact=True), has_real
