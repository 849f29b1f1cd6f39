"""Host helpers of the port: C-semantics formatting, logging, timing and
argument parsing (copies of ``cornetto_tpu.utils`` that the port uses)."""

from cornetto_tpu_torch.utils.cformat import (c_round, c_div, wrap_i32, fmt_g,
                                              fmt_float)
from cornetto_tpu_torch.utils.natsort import (strnum_cmp, strnum_key,
                                              mixed_numcompare, mixed_key)
from cornetto_tpu_torch.utils.parsing import parse_num_suffix
