// Registry constants of the lock simulator, as the CUDA kernel sees them.
//
// Every value here mirrors repro_torch/core/policy.py and
// repro_torch/kernels/ref.py; tests/test_torch_kernel_contract.py parses
// this file (one `constexpr <type> NAME = value;` per line) and fails when
// the two drift apart or when a registry gains an id without an entry here.
#pragma once

// thread states (policy.NCS .. policy.DONE)
constexpr int ST_NCS = 0;
constexpr int ST_CS = 1;
constexpr int ST_SPIN = 2;
constexpr int ST_SLEEP = 3;
constexpr int ST_WAKING = 4;
constexpr int ST_DONE = 5;

// discipline ids (policy.POLICY_IDS)
constexpr int POLICY_TAS = 0;
constexpr int POLICY_TTAS = 1;
constexpr int POLICY_MCS = 2;
constexpr int POLICY_SLEEP = 3;
constexpr int POLICY_ADAPTIVE = 4;
constexpr int POLICY_MUTABLE = 5;
constexpr int POLICY_FIFO = 6;
constexpr int POLICY_FISSILE = 7;
constexpr int POLICY_HAPAX = 8;
constexpr int POLICY_TTAS_BACKOFF = 9;
constexpr int N_POLICY = 10;

// discipline capability flags (policy.DISCIPLINE_FLAG_ATTRS order, bit i =
// attribute i): handoff, fifo_grant, budget_spin, wake_to_spin, repark,
// windowed, budget_scaled, backoff
constexpr unsigned F_HANDOFF = 1u;
constexpr unsigned F_FIFO = 2u;
constexpr unsigned F_BUDGET = 4u;
constexpr unsigned F_W2S = 8u;
constexpr unsigned F_REPARK = 16u;
constexpr unsigned F_WINDOWED = 32u;
constexpr unsigned F_BSCALED = 64u;
constexpr unsigned F_BACKOFF = 128u;

// arrival rules (DisciplineRow.arrival_sleeps) and release-quota rules
// (DisciplineRow.quota), by the name of the row function in policy.py
constexpr int ARRIVE_NEVER = 0;
constexpr int ARRIVE_SLEEP_LOCK = 1;
constexpr int ARRIVE_WINDOW = 2;
constexpr int ARRIVE_FIFO_PARK = 3;
constexpr int QUOTA_ZERO = 0;
constexpr int QUOTA_WAKE_ONE = 1;
constexpr int QUOTA_WAKE_ONE_NO_HANDOFF = 2;
constexpr int QUOTA_MUTABLE = 3;

// per policy id: flags | arrival rule << 8 | quota rule << 12
constexpr unsigned ROW_TAS = 0x0001u;
constexpr unsigned ROW_TTAS = 0x0001u;
constexpr unsigned ROW_MCS = 0x0001u;
constexpr unsigned ROW_SLEEP = 0x1110u;
constexpr unsigned ROW_ADAPTIVE = 0x2015u;
constexpr unsigned ROW_MUTABLE = 0x3229u;
constexpr unsigned ROW_FIFO = 0x0003u;
constexpr unsigned ROW_FISSILE = 0x206Du;
constexpr unsigned ROW_HAPAX = 0x1302u;
constexpr unsigned ROW_TTAS_BACKOFF = 0x0080u;

// oracle family ids (policy.ORACLE_IDS)
constexpr int ORACLE_PAPER = 0;
constexpr int ORACLE_AIMD = 1;
constexpr int ORACLE_FIXED = 2;
constexpr int ORACLE_HISTORY = 3;
constexpr int N_ORACLE = 4;

// workload row ids (policy.WORKLOAD_IDS)
constexpr int WL_CONSTANT = 0;
constexpr int WL_BURSTY = 1;
constexpr int WL_HETERO = 2;
constexpr int WL_JITTER = 3;
constexpr int N_WORKLOAD = 4;

// fault row ids (policy.FAULT_IDS)
constexpr int FAULT_NONE = 0;
constexpr int FAULT_PREEMPT = 1;
constexpr int FAULT_OVERSUB = 2;
constexpr int FAULT_LOSTWAKE = 3;
constexpr int FAULT_JITTER = 4;
constexpr int N_FAULT = 5;

// tie-break ids (policy.TIE_BREAK_IDS)
constexpr int TB_ID = 0;
constexpr int TB_RANDOM = 1;
constexpr int N_TIE_BREAK = 2;

// arrival row ids (policy.ARRIVAL_IDS)
constexpr int AR_CLOSED = 0;
constexpr int AR_POISSON = 1;
constexpr int AR_BURSTY = 2;
constexpr int N_ARRIVAL = 3;

// seed salts of the counter-RNG streams
constexpr unsigned BO_SALT = 0x165667B1u;
constexpr unsigned WL_PHASE_SALT = 0x7F4A7C15u;
constexpr unsigned WL_SPREAD_SALT = 0x6C62272Eu;
constexpr unsigned TB_SALT = 0xD6E8FEB8u;
constexpr unsigned FLT_GATE_SALT = 0xA3C59AC3u;
constexpr unsigned FLT_WAKE_SALT = 0xC2B2AE35u;
constexpr unsigned FLT_MAG_SALT = 0x27220A95u;
constexpr unsigned AR_SALT = 0x94D049BBu;
constexpr unsigned AR_PHASE_SALT = 0xBF58476Du;

// oracle / backoff fixed-point knobs
constexpr int EWMA_ONE = 256;
constexpr int EWMA_SHIFT = 3;
constexpr int BO_CAP = 6;

// engine sentinels (kernels/ref.py)
constexpr float REM_EPS = 1e-9f;
constexpr int NO_TICKET = 2147483647;

// widest simulated-thread axis one warp carries (4 slots per lane)
constexpr int MAX_T = 128;

// open-loop engine: request ring width and latency histogram layout
constexpr int QUEUE_MAX = 128;
constexpr int LAT_NBINS = 64;
constexpr float LAT_BIN0 = 1e-7f;
constexpr int LAT_BINS_PER_OCTAVE = 2;
