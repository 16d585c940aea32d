"""The card's peaks and the least work of each hand-written kernel of the
program, frozen here so that a change to the program cannot move them.

The hand kernels are matched by their function names in the device
trace (HAND_KERNELS: every ``__global__`` of nart_tpu_torch/csrc/*.cu when
the benchmark was written).  A launch's least time is the larger of its
bytes over the peak bandwidth and its operations over the peak rate of
their kind (float32 and float64 run on separate pipes):

  * lanes: the lanes a launch is given, LANES_PER_SLOT times the
    machine's work slots (every call of a round runs on the slots; an
    any-hit walk takes both strategies' shadow rays, twice the slots);
  * bytes: LANE_BYTES a lane, what every lane must move whatever its
    data (chip_smoke.py's counts cut to their data-independent part):
    walk_kernel (K1/K2) and bvh_walk_kernel (B1), the ray (o, d, t_min,
    t_max: 32 B) and one byte out (an any-hit flag; a closest hit writes
    16); lut_gather_many_kernel, the index (8 B) and one float out; the
    backward lut_bwd_many_kernel and S2's lut_seg_kernel, the index and
    one float of cotangent in; bsdf_sample_kernel (X1), n_lobes, a lobe
    code and u1 (20 B) in and its 48 B out; bsdf_sample_eval_kernel, X1's
    and f_b and pdf_b (16 B); bsdf_eval_kernel, n_lobes, a code, f and pdf
    (32 B); bsdf_f_bwd_kernel (X3), the lobe bits, g_f and 64 B of rows
    out; vol_steps_kernel (V1), 158 B; vol_steps_bwd_kernel (V2), 146 B
    and one step's 40 B of cotangent rows and indices;
  * operations: a lane's count of each kind, which depends on the scene's
    rays and lobes and so comes from the configuration
    (configs/<name>.json's "kernel_ops_per_lane", counted by
    chip_smoke.py on that scene); a walk is keyed "walk_kernel.closest"
    or "walk_kernel.any" by its template's any-hit flag.
Kernels with no count (the references no path launches, the sorts'
helpers) count their device time with no least time, so a share errs
low.
"""

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores
PEAK_F64 = 34e12  # float64 FLOP/s outside the tensor cores

HAND_KERNELS = (
    "walk_kernel", "bvh_walk_kernel", "bvh_walk_ref_kernel",
    "lut_gather_many_kernel", "lut_partial_kernel", "lut_final_kernel",
    "lut_bwd_many_kernel", "lut_sort_kernel", "lut_seg_kernel",
    "lut_carry_kernel", "bsdf_sample_kernel", "bsdf_eval_kernel",
    "bsdf_sample_eval_kernel", "bsdf_f_bwd_kernel", "vol_steps_kernel",
    "vol_steps_bwd_kernel", "vol_steps_ref_kernel",
    "vol_steps_bwd_ref_kernel", "vol_empty_kernel", "vol_trig_check_kernel",
)

LANE_BYTES = {
    "walk_kernel": 33,
    "bvh_walk_kernel": 33,
    "lut_gather_many_kernel": 12,
    "lut_bwd_many_kernel": 12,
    "lut_seg_kernel": 12,
    "bsdf_sample_kernel": 68,
    "bsdf_sample_eval_kernel": 84,
    "bsdf_eval_kernel": 32,
    "bsdf_f_bwd_kernel": 80,
    "vol_steps_kernel": 158,
    "vol_steps_bwd_kernel": 186,
}


LANES_PER_SLOT = {"walk_kernel.any": 2}


def base_name(name):
    """A device function's name without its return type, namespaces,
    template arguments and parameters: "void (anonymous
    namespace)::walk_kernel<4, true, false>(float const*, ...)" ->
    "walk_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def is_hand(name):
    return base_name(name) in HAND_KERNELS


def family(name):
    """A launch's key in the tables: its base name, and for the cluster
    walk whether it is the any-hit one (walk_kernel<tiles, any, stats>)."""
    base = base_name(name)
    if base == "walk_kernel":
        args = name.split("<", 1)[1].split(">", 1)[0].split(",")
        return "walk_kernel." + ("any" if args[1].strip() == "true"
                                 else "closest")
    return base


def least_s(name, slots, ops=None):
    """A launch's least time (s) on the lanes its family takes on `slots`
    work slots; 0 for a kernel with no count.  ops: the configuration's
    operations a lane, {"f32": {key: n}, "f64": {key: n}}."""
    key = family(name)
    lanes = LANES_PER_SLOT.get(key, 1) * slots
    ops = ops or {}
    return lanes * max(LANE_BYTES.get(base_name(name), 0) / PEAK_BYTES,
                       ops.get("f32", {}).get(key, 0) / PEAK_F32,
                       ops.get("f64", {}).get(key, 0) / PEAK_F64)


def roofline_pct(launches, slots, ops=None):
    """The share (%) of the hand kernels' device time that their least
    times make: launches is [(name, device seconds)], one a launch, of
    hand kernels only.  None where they took no time."""
    busy = sum(s for _, s in launches)
    if not busy > 0:
        return None
    return 100.0 * sum(least_s(n, slots, ops) for n, _ in launches) / busy
