"""readfish interop: target CSV rows (as bigenough emits) and the protocol's
hand-written TOML config, generated instead
(reference: docs/protocol.md:139-161 shows the TOML the user writes by hand;
src/bigenough_main.c:208-211 emits the +/- CSV rows)."""

from typing import Iterable, Tuple


def write_readfish_toml(out, *, reference_mmi: str, targets_csv: str,
                        deplete: bool = True,
                        channels: Tuple[int, int] = (1, 512)) -> None:
    """A readfish experiment TOML for a Cornetto reject panel: reads mapping
    into the targets (boring bits) are unblocked, everything else proceeds
    (single_off -> proceed keeps sequencing unmapped reads, matching the
    livefish engine's accept-on-unmapped policy)."""
    out.write("[caller_settings]\n")
    out.write('config_name = "dna_r10.4.1_e8.2_400bps_5khz_fast_prom"\n\n')
    out.write("[conditions]\n")
    out.write('reference = "%s"\n\n' % reference_mmi)
    out.write("[conditions.0]\n")
    out.write('name = "cornetto_panel"\n')
    out.write("control = false\n")
    out.write("min_chunks = 0\n")
    out.write("max_chunks = 4\n")
    out.write('targets = "%s"\n' % targets_csv)
    if deplete:
        out.write('single_on = "unblock"\n')
        out.write('multi_on = "unblock"\n')
        out.write('single_off = "proceed"\n')
        out.write('multi_off = "proceed"\n')
    else:
        out.write('single_on = "stop_receiving"\n')
        out.write('multi_on = "stop_receiving"\n')
        out.write('single_off = "unblock"\n')
        out.write('multi_off = "unblock"\n')
    out.write('no_seq = "proceed"\nno_map = "proceed"\n')
