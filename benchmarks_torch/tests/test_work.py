"""Each work function against chip_smoke.py's bound column at the 256³
shapes of PERF.md's kernel table (the bound in ms, four digits)."""

import pytest

import run
import traced
import yardstick

P = 0  # a pointer argument: its value is never read
# (entry, args without the stream, bound ms in PERF.md §6, row)
CASES = [
    ("fft_axis", (P,) * 5 + (1, 256, 256 * 128, 0), 0.0401, "1"),
    ("packed_rfft", (P,) * 5 + (256 * 256, 256), 0.0401, "4"),
    ("packed_irfft", (P,) * 5 + (256 * 256, 256), 0.0401, "5"),
    ("planar_rfft", (P,) * 5 + (3 * 384 * 384, 384, 129, 129, 1, 0.3),
     0.3391, "8"),
    ("planar_irfft", (P,) * 5 + (3 * 384 * 384, 384, 129, 129, 3.4),
     0.3391, "9"),
    ("curl_ifft_x", (P,) * 8 + (256, 256, 128, 1, 0), 0.1803, "11"),
    ("cross_rfft_z", (P,) * 8 + (256 * 256, 256, 0), 0.1803, "12"),
    ("cross_rfft_z", (P,) * 8 + (256 * 256, 256, 1), 0.3005, "12 cross2"),
    ("cross_rfft_z", (P,) * 8 + (256 * 256, 256, 2), 0.1402, "15"),
    ("fft_x_epilogue", (P,) * 4 + (None, None) + (P,) * 9
     + (256, 256, 128, 1e-3, 0, 0.0), 0.1803, "14 project"),
    ("fft_x_epilogue", (P,) * 4 + (None, None) + (P,) * 9
     + (256, 256, 128, 1e-3, 1, 0.0), 0.1803, "14 curl"),
    ("fft_x_epilogue", (P,) * 4 + (None, None) + (P,) * 9
     + (256, 256, 128, 1e-3, 2, 0.0), 0.1002, "14 div"),
    ("fft_x_epilogue", (P,) * 15 + (256, 256, 128, 1e-3, 0, 0.5), 0.2003,
     "14 buoy"),
]


@pytest.mark.parametrize("entry,args,ms,row", CASES,
                         ids=[f"row {c[3]}" for c in CASES])
def test_bound_matches_chip_smoke(entry, args, ms, row):
    nbytes, flops = traced._work(entry)(args)
    assert round(yardstick.bound_s(nbytes, flops) * 1e3, 4) == ms


def test_bound_is_bytes_at_these_shapes():
    # 5 n log2 n at 67 TFLOP/s is far below the bytes at 3.35 TB/s
    for entry, args, _, _ in CASES:
        nbytes, flops = traced._work(entry)(args)
        assert nbytes / yardstick.HBM_BYTES_PER_S > \
            flops / yardstick.FP32_FLOPS_PER_S


def test_every_entry_of_the_cells_has_a_work_file():
    # the C entries that the four cells' timed paths launch
    for entry in ("fft_axis", "packed_rfft", "packed_irfft", "planar_rfft",
                  "planar_irfft", "curl_ifft_x", "cross_rfft_z",
                  "fft_x_epilogue"):
        assert traced._work(entry) is not None
    assert traced._work("no_such_kernel") is None
    assert run.HERE
