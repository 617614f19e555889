"""The kernels' shared build and launch steps in ``kernels/_build.py``, on
the CPU:

  * a library's name hashes its source, then the ``csrc/`` headers it
    includes (through one another too, depth first), then the flags: an
    edited included header builds a second library, an edited header that
    no ``#include`` reaches builds none (host sources stand in for the
    ``.cu`` ones, which need ``nvcc``);
  * the one tensor check the wrappers share raises ``ValueError`` for the
    device, shape and layout and ``TypeError`` for the dtype, with the
    words the card tests match.
"""

import hashlib
import subprocess
from unittest import mock

import pytest
import torch

from repro_torch.kernels import _build


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    texts = {
        "probe.cpp": '#include "outer.h"\n'
                     'extern "C" int value() { return outer(); }\n',
        "outer.h": '#pragma once\n#include "inner.h"\n'
                   "inline int outer() { return inner() + 1; }\n",
        "inner.h": "inline int inner() { return 2; }\n",
        "other.h": "inline int other() { return 5; }\n",
    }
    for name, text in texts.items():
        (csrc / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)

    def load():
        monkeypatch.setattr(_build, "_libs", {})
        return _build.bind("probe", {"value": []}, host=True)

    def built():
        return sorted(p.name for p in out.glob("libprobe-*.so"))

    assert load().value() == 3
    order = "".join(texts[n] for n in ("probe.cpp", "outer.h", "inner.h"))
    digest = hashlib.sha1((order + " ".join(_build.CXX_FLAGS)).encode()
                          ).hexdigest()[:12]
    assert built() == [f"libprobe-{digest}.so"]

    # a header that no #include reaches: the same library, no compile
    (csrc / "other.h").write_text("inline int other() { return 6; }\n")
    with mock.patch.object(subprocess, "Popen",
                           side_effect=AssertionError("compiled again")):
        assert load().value() == 3
    assert built() == [f"libprobe-{digest}.so"]

    # a header included through another: a second library
    (csrc / "inner.h").write_text("inline int inner() { return 7; }\n")
    assert load().value() == 8
    assert len(built()) == 2


_CPU = torch.device("cpu")


@pytest.mark.parametrize("case", [
    "device", "dtype", "dtypes", "shape", "contiguous", "any layout", "fits",
])
def test_shared_tensor_check_types_and_words(case):
    t = torch.zeros((4, 6), dtype=torch.int32)
    args = {
        "device": (t, torch.int32, (4, 6), torch.device("meta"), True),
        "dtype": (t.long(), torch.int32, (4, 6), _CPU, True),
        "dtypes": (t.float(), (torch.int8, torch.int16), (4, 6), _CPU, True),
        "shape": (t, torch.int32, (4, 5), _CPU, True),
        "contiguous": (t.t(), torch.int32, (6, 4), _CPU, True),
        "any layout": (t.t(), torch.int32, (6, 4), _CPU, False),
        "fits": (t.short(), (torch.int8, torch.int16), (4, 6), _CPU, True),
    }[case]
    want = {
        "device": (ValueError, "w is on cpu, expected meta"),
        "dtype": (TypeError, "w has dtype torch.int64, expected torch.int32"),
        "dtypes": (TypeError, "w has dtype torch.float32, expected one of "
                              r"\(torch.int8, torch.int16\)"),
        "shape": (ValueError, r"w has shape \(4, 6\), expected \(4, 5\)"),
        "contiguous": (ValueError, "w must be contiguous"),
    }.get(case)
    t, dtype, shape, device, contiguous = args
    if want is None:
        assert _build.check("w", t, dtype, shape, device, contiguous) is None
    else:
        with pytest.raises(want[0], match=want[1]):
            _build.check("w", t, dtype, shape, device, contiguous)
