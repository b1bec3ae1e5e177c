"""The kernel probe's variants against the kernels' sources.

``python3 -m zhpe_ompi_tpu_torch._flash_probe`` builds each variant by text
substitution in a copy of ``zhpe_ompi_tpu_torch/csrc``; a substitution that
matches nothing, or matches twice (the dq and dk/dv kernels share
``flash_attention_bwd.cu``), would time another kernel than the one named.
Each variant's substitutions must match their source exactly once, and
change it.  Pure text: runs on the CPU.
"""

import os

import pytest

from zhpe_ompi_tpu_torch import _flash_probe as fp

CSRC = os.path.join(os.path.dirname(fp.__file__), "csrc")
VARIANTS = [(kind, name) for kind, (_, table) in fp.KINDS.items() for name in table]


@pytest.mark.parametrize("kind,name", VARIANTS, ids=[f"{k}-{n}" for k, n in VARIANTS])
def test_variant_substitutions_match_their_source_once(kind, name):
    src, table = fp.KINDS[kind]
    with open(os.path.join(CSRC, src + ".cu")) as fh:
        text = fh.read()
    out = fp.apply_variant(text, kind, name)
    assert (out == text) == (name == "kernel")


def test_a_substitution_that_matches_twice_is_refused():
    with pytest.raises(ValueError, match="once"):
        fp.apply_variant("kStages = HD <= 64 ? 3 : 2;\n  static constexpr int kKV\n" * 2,
                         "dkv", "stages_2")
