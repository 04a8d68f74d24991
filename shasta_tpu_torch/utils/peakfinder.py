"""Topographic-prominence peak detection on coverage histograms.

Counterpart of the reference PeakFinder (reference:
src/PeakFinder.{hpp,cpp}, used to auto-select
MarkerGraph.minCoverage at src/AssemblerMarkerGraph.cpp:230-250):
persistence-homology peak detection (points visited in decreasing
height; adjacent peak domains merge into the taller peak, the weaker
peak's persistence = taller peak height - merge height), then the
cutoff is the left bound of the second-most-persistent peak, accepted
only if that peak holds at least minAreaFraction of the histogram
area from areaFractionStartIndex on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


class PeakFinderException(Exception):
    def __init__(self, min_percent_area: float, observed_percent_area: float):
        self.min_percent_area = min_percent_area
        self.observed_percent_area = observed_percent_area
        super().__init__(
            f"no significant peak: observed area fraction "
            f"{observed_percent_area:.4f} < {min_percent_area:.4f}"
        )


@dataclass
class Peak:
    start: int  # x of the local maximum
    left: int
    right: int
    stop: int = -1
    persistence: float = float("inf")
    is_merged: bool = False


def find_peaks(y: np.ndarray) -> List[Peak]:
    """Persistence peak detection (reference: PeakFinder::findPeaks)."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    order = sorted(range(n), key=lambda i: (-y[i], i))
    peak_index = [-1] * n
    peaks: List[Peak] = []

    for i in order:
        has_left = i > 0 and peak_index[i - 1] >= 0
        has_right = i < n - 1 and peak_index[i + 1] >= 0
        if not has_left and not has_right:
            peaks.append(Peak(start=i, left=i, right=i))
            peak_index[i] = len(peaks) - 1
        elif has_left and not has_right:
            p = peaks[peak_index[i - 1]]
            p.right = i
            peak_index[i] = peak_index[i - 1]
        elif has_right and not has_left:
            p = peaks[peak_index[i + 1]]
            p.left = i
            peak_index[i] = peak_index[i + 1]
        else:
            left_peak = peaks[peak_index[i - 1]]
            right_peak = peaks[peak_index[i + 1]]
            if y[right_peak.start] > y[left_peak.start]:
                right_peak.left = left_peak.left
                peak_index[i] = peak_index[i + 1]
                left_peak.right = i
                peak_index[left_peak.left] = peak_index[i + 1]
                peak_index[left_peak.right] = peak_index[i + 1]
                left_peak.stop = i
                left_peak.is_merged = True
                left_peak.persistence = y[right_peak.start] - y[i]
            else:
                left_peak.right = right_peak.right
                peak_index[i] = peak_index[i - 1]
                right_peak.left = i
                peak_index[right_peak.right] = peak_index[i - 1]
                peak_index[right_peak.left] = peak_index[i - 1]
                right_peak.stop = i
                right_peak.is_merged = True
                right_peak.persistence = y[left_peak.start] - y[i]
    return peaks


def find_x_cutoff(
    y: np.ndarray,
    min_area_fraction: float = 0.08,
    area_start_index: int = 0,
) -> int:
    """The reference's findXCutoff (src/PeakFinder.cpp:158): left
    bound of the second-most-persistent peak, validated by area."""
    y = np.asarray(y, dtype=np.float64)
    peaks = find_peaks(y)
    if len(peaks) < 2:
        raise PeakFinderException(min_area_fraction, 0.0)
    peaks.sort(key=lambda p: -p.persistence)

    if peaks[1].start < peaks[0].start:
        left_bound = peaks[1].right
        right_bound = peaks[0].right
    else:
        left_bound = peaks[1].left
        right_bound = peaks[1].right

    total_area = float(y[area_start_index:].sum())
    peak_area = float(y[left_bound : right_bound + 1].sum())
    area_fraction = peak_area / max(total_area, 1e-12)
    if area_fraction > min_area_fraction:
        return int(left_bound)
    raise PeakFinderException(min_area_fraction, area_fraction)
