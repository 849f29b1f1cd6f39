"""Interval algebra on BED rows (a copy of ``cornetto_tpu.intervals``)."""

from cornetto_tpu_torch.intervals.algebra import (IntervalSet, bed_sort,
                                                  gnu_sort_bed, merge,
                                                  subtract, intersect_wa)
