"""Count the instructions of the pair kernel's erfc window in SASS.

Builds a probe with nvcc for sm_90a (the flags of
shenqi_tpu_torch/_build.py) and disassembles it with cuobjdump.  Each
probe kernel reads x, evaluates one window output as csrc/p2p.cu's
`Window<kErfc>::eval` does (u = x ku, erfcf(u) + 2/sqrt(pi) u
expf(-u^2) for the force, erfcf(u) for the potential) and stores it;
an identity kernel that stores x (and one that stores it twice) is
subtracted opcode by opcode.  Prints the opcode counts of the force
window and of what the potential adds, and their tally
(shenqi_tpu_torch/ops/p2p.py sass_tally: operations with an FFMA
counted 2, FFMAs, MUFU instructions), and exits 1 if the opcodes that
do work differ from the table the port prices its bound with
(ERFC_FORCE_SASS, ERFC_POT_SASS).  chip_smoke.py's build phase calls
count() and check().

Needs the CUDA toolkit (nvcc, cuobjdump); no card.  Run:
    python3 tools/torch_erfc_sass.py [--out chiprun_out/erfc_sass.json]
"""

import collections
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PROBE = r"""
constexpr float kTwoOverSqrtPi = 1.12837916709551257f;
extern "C" __global__ void probe_id(const float* x, float* o, float k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = x[i];
}
extern "C" __global__ void probe_id2(const float* x, float* o, float* p,
                                     float k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  o[i] = x[i];
  p[i] = x[i];
}
extern "C" __global__ void probe_force(const float* x, float* o, float k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float u = x[i] * k;
  o[i] = erfcf(u) + kTwoOverSqrtPi * u * expf(-u * u);
}
extern "C" __global__ void probe_both(const float* x, float* o, float* p,
                                      float k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float u = x[i] * k;
  const float e = erfcf(u);
  o[i] = e + kTwoOverSqrtPi * u * expf(-u * u);
  p[i] = e;
}
"""


def sass_opcodes(text):
    """{function: Counter(opcode)} from cuobjdump -sass output."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and fn:
            out[fn][m.group(2)] += 1
    return out


def count():
    """Build the probes and count their SASS: {"nvcc", "force_opcodes",
    "pot_opcodes", "dropped_opcodes", "ERFC_FORCE", "ERFC_POT", "sass"}."""
    from shenqi_tpu_torch._build import NVCC_FLAGS, find_nvcc
    from shenqi_tpu_torch.ops.p2p import sass_tally
    nvcc = find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    arch = [f for f in NVCC_FLAGS if f.startswith("arch=")]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([nvcc, "-cubin", "-gencode", arch[0], "-O3",
                        "-std=c++17", "-o", cubin, src], check=True)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    ops = sass_opcodes(text)
    force = ops["probe_force"] - ops["probe_id"]
    both = ops["probe_both"] - ops["probe_id2"]
    pot = both - force
    neg = (ops["probe_id"] - ops["probe_force"]) + (
        ops["probe_id2"] - ops["probe_both"])
    return {"nvcc": subprocess.run([nvcc, "--version"], capture_output=True,
                                   text=True).stdout.strip().splitlines()[-1],
            "force_opcodes": dict(sorted(force.items())),
            "pot_opcodes": dict(sorted(pot.items())),
            "dropped_opcodes": dict(sorted(neg.items())),
            "ERFC_FORCE": sass_tally(force), "ERFC_POT": sass_tally(pot),
            "sass": text}


def check(res):
    """[] if the counted opcodes that do work are the port's table, else
    the lines that say how they differ."""
    from shenqi_tpu_torch.ops import p2p
    bad = []
    for what, got, table in (
            ("force", res["force_opcodes"], p2p.ERFC_FORCE_SASS),
            ("potential", res["pot_opcodes"], p2p.ERFC_POT_SASS)):
        got, want = p2p.sass_work(got), p2p.sass_work(table)
        if got != want:
            bad.append(f"the erfc {what} window's SASS ({res['nvcc']}) "
                       f"is {dict(sorted(got.items()))}, the table in "
                       f"ops/p2p.py {dict(sorted(want.items()))}")
    return bad


def main(argv):
    res = count()
    text = res.pop("sass")
    for fn, c in sorted(sass_opcodes(text).items()):
        print(f"{fn}: {sum(c.values())} instructions "
              f"{dict(sorted(c.items()))}")
    print(json.dumps(res))
    if "--out" in argv:
        path = argv[argv.index("--out") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({**res, "sass": text}, f, indent=1)
    bad = check(res)
    for line in bad:
        print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
