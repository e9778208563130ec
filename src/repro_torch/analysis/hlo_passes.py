"""Collective pass: the traffic contract of the sharded fan-out.

Port of ``repro/analysis/hlo_passes.py``. DESIGN.md section 8's
partition contract says the node-sharded query path pays exactly two
collectives: a psum row fetch (the replicated query rows -- one
all-reduce per packed array) and a per-push-step frontier all-gather
(plus two small candidate-merge gathers on the top-k path). The
reference AOT-compiles the four sharded jits and parses their HLO. The
port runs each sharded program once under the op walk
(``launch/hlo_walk.py``) on a mesh of two distinct fake devices
(``meta:0``, ``meta:1``; ``analysis/programs.py``), where every copy
between the devices is a collective under the kind that the code around
it names (``kernels/cost.collective``), and flags

  * any kind outside {all-reduce, all-gather} -- the walk's "copy" (a
    copy that no code names) and "host" included: a new collective is a
    contract break, whatever its size;
  * collective bytes on the busiest device beyond ``SLACK`` x the ring
    model of the contract (psum + frontier gathers + merge gathers) --
    the eager copies may take another route than XLA's ring, not move
    more data.

The mesh is fake, so the pass runs on every host and never skips.
"""
from __future__ import annotations

from repro_torch.analysis import programs
from repro_torch.analysis.core import Context, Finding, Pass

ALLOWED_KINDS = ("all-reduce", "all-gather")
SLACK = 1.5


def contract_model_bytes(kind: str, *, B: int, W: int, n: int, S: int,
                         l_max: int, k: int = 16) -> float:
    """Ring-model bytes/device the section-8 contract permits."""
    f = (S - 1) / S
    psum = 2 * (2 * B * W * 4) * f            # keys+vals all-reduce
    frontier = l_max * (B * n * 4) * f        # one gather per push step
    merge = 0.0
    if kind == "topk":
        k_loc = min(k, n // S)
        merge = 2 * (B * S * k_loc * 4) * f   # scores + ids gathers
    return psum + frontier + merge


def walk_spec(spec: programs.ProgramSpec, devices=None):
    """The op walk of one call of a sharded spec (on its default fake
    mesh, or on ``devices``) and the host syncs it made."""
    from repro_torch.analysis.jaxpr_passes import run_program
    fn, args = spec.make() if devices is None else spec.make(devices)
    return run_program(fn, args)


class CollectiveContractPass(Pass):
    """Sharded programs move psum + all-gather traffic only."""

    pass_id = "collective-contract"

    def run(self, ctx: Context) -> list[Finding]:
        findings: list[Finding] = []
        for spec in programs.build_specs():
            if spec.devices >= 2:
                findings.extend(self.check_spec(spec))
        return findings

    def check_spec(self, spec: programs.ProgramSpec,
                   uni: dict | None = None) -> list[Finding]:
        """The findings of one sharded program on its analysis mesh."""
        if uni is None:
            uni = programs.universe()
        g = programs._geometry(uni)
        try:
            walk, _ = walk_spec(spec)
        except Exception as e:
            return [Finding(
                pass_id=self.pass_id, file=spec.file, line=1,
                key=f"{spec.name}:walk",
                message=f"{spec.name} failed to run on the analysis "
                        f"mesh: {type(e).__name__}: {e}")]
        findings: list[Finding] = []
        for op in sorted(walk.coll_by_op):
            if op not in ALLOWED_KINDS:
                findings.append(Finding(
                    pass_id=self.pass_id, file=spec.file, line=1,
                    key=f"{spec.name}:kind:{op}",
                    message=f"{spec.name} moves "
                            f"{walk.coll_by_op[op]:.0f} bytes as '{op}'; "
                            "the section-8 contract allows only "
                            f"{ALLOWED_KINDS}"))
        kind = "topk" if "topk" in spec.name else "source"
        budget = SLACK * contract_model_bytes(
            kind, B=uni["source_batch"], W=g["W"], n=g["n"],
            S=spec.devices, l_max=g["l_max"])
        moved = float(walk.coll_bytes)
        if moved > budget:
            findings.append(Finding(
                pass_id=self.pass_id, file=spec.file, line=1,
                key=f"{spec.name}:bytes",
                message=f"{spec.name} moves {moved:.0f} collective bytes "
                        f"on its busiest device, over {budget:.0f} "
                        f"({SLACK}x the psum + frontier all-gather "
                        "contract model)"))
        return findings
