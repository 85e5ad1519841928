"""All reference-behavior constants in one place.

The port's own copy of ``desamba_tpu/constants.py``, equal name for name
(``tests/test_torch_copies.py``). Each constant cites where the reference
(hitbc/deSAMBA) defines it, since together they pin down output parity
(SURVEY.md §2.1, §5 "Config").
"""

# ---- k-mer / index geometry -------------------------------------------------
B_KMER = 31                 # index k-mer length (src/idx.c:8)
L_PRE_IDX = 13              # 13-bp prefix jumpstart for FM search (src/idx.h:49)
PRE_IDX_MASK = 0x3FFFFFF    # 26-bit mask (src/idx.h:50)
MIN_UNI_L = 35              # min unitig length used at classify (src/idx.h:31)
NUM_BP_OCCUPY_ONE_SA = 8    # SA sampling stride (src/bwt.h:6)
SA_MASK = 0x7               # (src/bwt.h:7)
SA_OFF = 3                  # (src/bwt.h:8)
BP_PER_BLOCK = 256          # FM checkpoint stride (src/bwt.c:108)

# ---- existence (e-kmer) filter ----------------------------------------------
STEP_EK = 3                 # probe every 3rd position (src/cly.c:974)
SEED_RANGE = 100            # top-island window, bp (src/cly.c:1024)
SINGLE_BASE_MAX_RATIO = 0.8  # low-complexity filter (src/idx.c:965)
# e_kmer_size -> (hash mask bits, e-kmer length)  (src/idx.c:966-982)
EKMER_PARAMS = {
    1 << 27: (30, 16),  # one_eighth_GigaByte
    1 << 28: (31, 17),
    1 << 29: (32, 17),
    1 << 30: (33, 18),
    1 << 31: (34, 18),
    1 << 32: (35, 19),
    1 << 33: (36, 19),
    1 << 34: (37, 20),  # sixteen_GigaByte
}

# ---- seeding ----------------------------------------------------------------
MEM_SEARCH_FAST = 2         # max FM interval, fast mode (src/cly.c:1476)
MIN_MEM_LEN_FAST = 21       # (src/cly.c:1477)
MEM_SEARCH_SLOW = 8         # (src/cly.c:1548)
MIN_MEM_LEN_SLOW = 20       # (src/cly.c:1549)
SP_SET_CAP = 500            # per-seed BWT-row dedup set size (src/cly.c:1487)
MIN_READ_LEN = 40           # ignore shorter reads (src/cly.c:3063)

# ---- anchor mapping / LV extension ------------------------------------------
LV_ERROR = 4                # max edit distance in LV (src/cly.c:498)
LV_L = 12                   # max LV query length (src/cly.c:704)
MIN_S_1 = 12                # early-fail prefix score (src/cly.c:696)
MIN_S_2 = 20                # anchor min score (src/cly.c:697)
SUPER_REPEAT_NOTE = 50      # occurrences > 50 noted (src/cly.c:847)
SUPER_REPEAT_DROP = 1000    # occurrences >= 1000 dropped (src/cly.c:883-886)

# ---- chaining ---------------------------------------------------------------
MAX_DIS_MINUS = 30          # diag delta for same chain (src/cly.c:114)
MAX_WAITING_LEN = 400       # max gap for same chain (src/cly.c:115)
MAX_ANCHOR_OVERLAP = 3      # M3 SDP overlap allowance (src/cly.c:237)
M3_ANCHOR_THRESHOLD = 50    # >=50 anchors -> M3 (src/cly.c:331)
M3_MAX_RUN = 1024           # anchors per SDP run (src/cly.c:256)
M3_RUN_GAP = 2000           # run split gap (src/cly.c:254)
CHAIN_KEEP = 5              # top chains kept (+ trailing with_top) (src/cly.c:345)

# ---- 9-mer rescoring (M2) ----------------------------------------------------
S_A_KMER_L = 9              # scoring k-mer length (src/cly.c:1712)
MIN_SCORE_MEM = 12          # min match block score (src/cly.c:1713)
OVER_SEARCH_M2 = 50         # ref over-read margin (src/cly.c:2226)
MAX_SMS_OVERLAP = 6         # (src/cly.c:2442-2443)
RESCORE_BASE = 10000        # basic score offset (src/cly.c:2446)
SDP_WINDOW = 600            # ref window per reload (src/cly.c:2578)
RESCORE_MAX_CHAINS_SOFT = 200  # (src/cly.c:2891-2895)
RESCORE_MAX_CHAINS_HARD = 400  # (src/cly.c:2897)

# ---- filtering ---------------------------------------------------------------
FILTER_MIN_SCORE_SHORT_3G = 30   # read < 310 (src/cly.c:2874)
FILTER_MIN_SCORE_2G = 26         # batch max read < 510 (src/cly.c:2875)
SHORT_READ_LEN_2G = 510          # (src/cly.c:2960)
SHORT_READ_LEN_3G = 310          # (src/cly.c:2969)

# ---- MAPQ model --------------------------------------------------------------
P_E = 0.15                  # assumed error rate (src/cly_mt.c:484)
Q_MEM_MAX = 2000            # (src/idx.h:52)
MAX_LV_WRONG = 20           # (src/idx.h:53)
MAX_LV_R_LEN = 20           # (src/idx.h:54)

# ---- classify driver defaults ------------------------------------------------
DEFAULT_L_MIN_MATCHING = 170   # -l (src/cly_mt.c:486)
DEFAULT_THREADS = 4
DEFAULT_MAX_SEC_N = 5          # -r
DEFAULT_MIN_SCORE = 64         # -s
N_NEEDED = 5000                # reads per batch (src/cly_mt.c:19)
MAX_READ_SIZE = 10_000_000     # bp per batch (src/cly_mt.c:20)

# ---- encodings ---------------------------------------------------------------
FORWARD = 1                 # direction codes (src/lib/desc.h: FORWARD/REVERSE)
REVERSE = 0
PRIMARY = 1
SECONDARY = 2
SUPPLEMENTARY = 3
CHAR_HASH = 4               # '#' unitig separator in BWT alphabet
CHAR_DOLLAR = 5             # '$' terminator
