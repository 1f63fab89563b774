"""The build's count of tensor-core instructions, on canned ``cuobjdump -sass``
text (no ``nvcc`` or ``cuobjdump`` needed).

``ops/build.py`` counts, per kernel function of a built library, the
tensor-core instructions of its SASS: ``HMMA`` (``mma.sync`` on 16-bit and
TF32 operands), ``IMMA`` (``mma.sync`` on int8), ``HGMMA`` (warpgroup
``wgmma`` on 16-bit operands) and ``IGMMA`` (``wgmma`` on int8).
``chip_smoke.py``'s build phase checks that the bf16 ViT attention holds
``HGMMA`` and the int8 conv ``IGMMA``. Here the counter reads text in the
layout ``cuobjdump -sass`` prints: a ``Function :`` header (a mangled name)
a kernel, one instruction a line with its address and encoding.
"""

import pytest
import torch_cpu_threads  # noqa: F401  (two torch threads a worker)

from textocvp_tpu_torch.ops import build

ATTENTION = "_ZN12_GLOBAL__N_121attention_bf16_kernelE14CUtensorMap_stS0_S0_P13__nv_bfloat16if"
ATTENTION_F32 = "_ZN12_GLOBAL__N_116attention_kernelEPKfS1_S1_Pfif"
CONV = ("_ZN12_GLOBAL__N_116conv_int8_kernelILi64EEEv14CUtensorMap_stPKaPKfS5_S5_PfNS_4PlanE")
OLD_CONV = "_ZN12_GLOBAL__N_116conv_int8_kernelEPKaS1_PKfS3_S3_Pfxiiiiii"

SASS = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : {ATTENTION}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
        /*0a40*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0a50*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0b70*/                   HGMMA.64x64x16.F32.BF16 R88, R120, gdesc[UR12], R88, gsb0 ;
        /*0c00*/                   MUFU.EX2 R3, R3 ;
        /*0c10*/                   EXIT ;
\t\t..........

\t\tFunction : {ATTENTION_F32}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.1688.F32.TF32 R16, R8, R14, R16 ;
        /*0120*/                   FFMA R2, R3, R4, R5 ;
\t\t..........

\t\tFunction : {CONV}
        /*0200*/                   IGMMA.64x64x32.S8.S8 R24, gdesc[UR4], R24, gsb0 ;
        /*0210*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
        /*0220*/                   IGMMA.64x64x32.S8.S8 R56, gdesc[UR8], R56, gsb0 ;
        /*0230*/                   STG.E.128 desc[UR6][R2.64], R8 ;
\t\t..........

\t\tFunction : {OLD_CONV}
        /*0300*/                   IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0310*/                   LDSM.16.M88.4 R8, [R2] ;
\t\t..........
"""


def test_counts_each_tensor_core_instruction_per_kernel_function():
    counts = build.tensor_core_counts(SASS)
    assert counts == {
        ATTENTION: {"HMMA": 0, "HGMMA": 3, "IMMA": 0, "IGMMA": 0},
        ATTENTION_F32: {"HMMA": 2, "HGMMA": 0, "IMMA": 0, "IGMMA": 0},
        CONV: {"HMMA": 0, "HGMMA": 0, "IMMA": 0, "IGMMA": 2},
        OLD_CONV: {"HMMA": 0, "HGMMA": 0, "IMMA": 1, "IGMMA": 0},
    }


@pytest.mark.parametrize("text", ["", "\tcode for sm_90a\n  /*0000*/  HGMMA.64x64x16 R0 ;\n"])
def test_instructions_before_any_function_header_count_for_none(text):
    assert build.tensor_core_counts(text) == {}


def test_a_mnemonic_inside_a_longer_word_is_not_counted():
    text = ("\t\tFunction : k\n"
            "  /*0000*/  UHGMMAX R0 ;\n  /*0010*/  MOV R1, HMMA_COUNT ;\n"
            "  /*0020*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")
    assert build.tensor_core_counts(text) == {"k": {"HMMA": 1, "HGMMA": 0, "IMMA": 0, "IGMMA": 0}}


def test_the_library_total_sums_every_function(monkeypatch):
    monkeypatch.setattr(build, "sass", lambda stem: SASS)
    assert build.tensor_core_by_function("conv_int8")[CONV]["IGMMA"] == 2
    assert build.tensor_core_instructions("vit_attention") == 3 + 2 + 2 + 1
