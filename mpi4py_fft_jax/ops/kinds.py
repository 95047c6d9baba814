"""Transform-kind and planner-flag vocabulary.

JAX replacement for the enum surface of the reference FFTW wrappers
(reference: mpi4py_fft/fftw/utilities.pyx:7-37).  The numeric values are kept
identical so user code that passes raw kind/flag integers keeps working.

There is no FFTW planner here, so the planner *flags* are accepted and
recorded but only influence JAX/XLA compilation knobs (see ops.plan).  The
*kinds* select the mathematical transform exactly as in FFTW.
"""

# --- transform kinds (reference: fftw/utilities.pyx:7-26) -------------------
FFTW_FORWARD = -1
FFTW_R2HC = 0
FFTW_BACKWARD = 1
FFTW_HC2R = 1
FFTW_DHT = 2
FFTW_REDFT00 = 3   # DCT-I
FFTW_REDFT01 = 4   # DCT-III
FFTW_REDFT10 = 5   # DCT-II
FFTW_REDFT11 = 6   # DCT-IV
FFTW_RODFT00 = 7   # DST-I
FFTW_RODFT01 = 8   # DST-III
FFTW_RODFT10 = 9   # DST-II
FFTW_RODFT11 = 10  # DST-IV

C2C_FORWARD = -1
C2C_BACKWARD = 1
R2C = -2
C2R = 2

# --- planner flags (reference: fftw/utilities.pyx:28-37) --------------------
# Accepted for API compatibility.  FFTW_MEASURE/PATIENT/... have no planning
# cost here: "planning" is XLA compilation, cached persistently (see
# ops.plan.export_wisdom).
FFTW_MEASURE = 0
FFTW_DESTROY_INPUT = 1
FFTW_UNALIGNED = 2
FFTW_CONSERVE_MEMORY = 4
FFTW_EXHAUSTIVE = 8
FFTW_PRESERVE_INPUT = 16
FFTW_PATIENT = 32
FFTW_ESTIMATE = 64
FFTW_WISDOM_ONLY = 2097152

flag_dict = {
    'FFTW_MEASURE': FFTW_MEASURE,
    'FFTW_DESTROY_INPUT': FFTW_DESTROY_INPUT,
    'FFTW_UNALIGNED': FFTW_UNALIGNED,
    'FFTW_CONSERVE_MEMORY': FFTW_CONSERVE_MEMORY,
    'FFTW_EXHAUSTIVE': FFTW_EXHAUSTIVE,
    'FFTW_PRESERVE_INPUT': FFTW_PRESERVE_INPUT,
    'FFTW_PATIENT': FFTW_PATIENT,
    'FFTW_ESTIMATE': FFTW_ESTIMATE,
    'FFTW_WISDOM_ONLY': FFTW_WISDOM_ONLY,
}

#: r2r kinds that are their own / each other's inverses
#: (reference: fftw/xfftn.py:818-827)
inverse_kind = {
    FFTW_RODFT11: FFTW_RODFT11,
    FFTW_REDFT11: FFTW_REDFT11,
    FFTW_RODFT01: FFTW_RODFT10,
    FFTW_RODFT10: FFTW_RODFT01,
    FFTW_REDFT01: FFTW_REDFT10,
    FFTW_REDFT10: FFTW_REDFT01,
    FFTW_RODFT00: FFTW_RODFT00,
    FFTW_REDFT00: FFTW_REDFT00,
    FFTW_R2HC: FFTW_HC2R,
    FFTW_DHT: FFTW_DHT,
}

R2R_KINDS = (FFTW_R2HC, FFTW_DHT,
             FFTW_REDFT00, FFTW_REDFT01, FFTW_REDFT10, FFTW_REDFT11,
             FFTW_RODFT00, FFTW_RODFT01, FFTW_RODFT10, FFTW_RODFT11)
