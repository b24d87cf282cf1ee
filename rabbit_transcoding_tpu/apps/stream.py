"""rabbit-stream — resumable live transcoding driver.

The GOF is the framework's natural checkpoint/batch unit (SURVEY.md §5.4:
each GOF is an independent context; the reference's only resilience is that
granularity, and its failure model is printf+exit, §5.3).  This driver makes
that explicit and robust:

 * completed GOFs append to the output immediately; a sidecar
   ``<out>.state.json`` records input identity (md5), parameters, and the
   completed-GOF count + output size — updated atomically after EVERY GOF;
 * ``--resume`` continues from the first unfinished GOF after a crash or
   restart (state and partial output are validated first);
 * ``--onError=skip`` drops a failing GOF and keeps the stream alive
   (``abort`` preserves reference behaviour);
 * multiple input streams (comma-separated) are transcoded concurrently —
   per-stream threads overlap host entropy with device compute
   (the BASELINE config-5 multi-stream mode);
 * ``--sharded=1`` + multiple inputs: all streams' GOFs are batched through
   ONE mesh-sharded device program per plane (transcoder/multistream.py) —
   the multi-chip scaling path (DP over streams, SP over atlas rows).
   Output bitstreams are byte-identical to the unsharded mode.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import sys
import time

from ..bitstream import V3CReader, V3CWriter
from ..bitstream.v3c import sample_stream_header, write_sample_stream_units
from ..transcoder.params import TranscoderParameters
from ..transcoder.transcoder import Transcoder
from ..utils.timing import Stopwatch, print_run_footer
from .common import build_registry, parse_or_help


@dataclasses.dataclass
class StreamParams(TranscoderParameters):
    resume: bool = False
    onError: str = "abort"   # abort | skip
    # GOFs in flight: >1 overlaps host entropy of one GOF with device
    # compute of the next (GOFs are independent; writes stay ordered).
    # Depth 3: one thread feeding entropy decode, one on device, one
    # deflating output
    pipelineDepth: int = 3
    # batch all input streams' GOFs through one mesh-sharded device
    # program (requires >1 input; output is byte-identical to unsharded)
    sharded: bool = False
    # write enc_* conformance trace logs per completed GOF (the same
    # emission rabbit-transcode --trace does; pair with rabbit-decode
    # --trace on the output and diff with rabbit-conformance).  Single
    # input stream only; costs one extra reconstruction per GOF.
    trace: bool = False


def _params_key(params: StreamParams) -> str:
    d = dataclasses.asdict(params)
    for k in ("compressedStreamPath", "outStreamPath", "resume", "sharded",
              "pipelineDepth", "trace"):
        d.pop(k, None)
    return hashlib.md5(json.dumps(d, sort_keys=True).encode()).hexdigest()


def _state_path(out_path: str) -> str:
    return out_path + ".state.json"


class _StreamIO:
    """One stream's input GOFs + checkpointed output (file + sidecar)."""

    def __init__(self, path_in: str, path_out: str, params: StreamParams):
        self.path_in = path_in
        self.path_out = path_out
        self.params = params
        with open(path_in, "rb") as f:
            data = f.read()
        self.input_md5 = hashlib.md5(data).hexdigest()
        self.reader = V3CReader()
        self.gofs = self.reader.read(data)
        self.pkey = _params_key(params)
        self.failures: list[dict] = []
        self.t0 = time.perf_counter()

        self.done = 0
        self._mode = "wb"
        spath = _state_path(path_out)
        if params.resume and os.path.exists(spath):
            try:
                state = json.load(open(spath))
                if (
                    state.get("input_md5") == self.input_md5
                    and state.get("params") == self.pkey
                    and os.path.exists(path_out)
                    and os.path.getsize(path_out) == state.get("out_bytes", -1)
                ):
                    self.done = state.get("gofs_done", 0)
                    # carry prior failures forward: the cumulative record
                    # stays correct and written = done - len(failures)
                    # keeps OUTPUT GOF numbering aligned across resumes
                    self.failures = list(state.get("failures", []))
                    self._mode = "ab"
                else:
                    print(f"{path_out}: stale state, restarting",
                          file=sys.stderr)
            except (json.JSONDecodeError, OSError):
                print(f"{spath}: unreadable state, restarting",
                      file=sys.stderr)
        self._f = None
        # GOFs actually present in the output so far (skips excluded):
        # the OUTPUT position the next written GOF will occupy — and the
        # numbering rabbit-decode --trace uses for the same GOF, so enc_*
        # trace keys must use this, not the input index (a skipped GOF is
        # absent from the written stream)
        self.written = self.done - len(self.failures)

    def __enter__(self):
        self._f = open(self.path_out, self._mode)
        if self._mode == "wb":
            # one sample-stream header per FILE; GOFs append units only
            self._f.write(sample_stream_header(4))
        return self

    def __exit__(self, *exc):
        self._f.close()
        self._f = None

    def _write_state(self) -> None:
        # atomic replace so a crash mid-dump never leaves a torn sidecar
        spath = _state_path(self.path_out)
        tmp = spath + ".tmp"
        with open(tmp, "w") as sf:
            json.dump(
                {
                    "input": self.path_in,
                    "input_md5": self.input_md5,
                    "params": self.pkey,
                    "gofs_done": self.done,
                    "gofs_total": len(self.gofs),
                    "out_bytes": self._f.tell(),
                    "failures": self.failures,
                },
                sf,
            )
        os.replace(tmp, spath)

    def write_gof(self, blob: bytes) -> None:
        self._f.write(blob)
        self._f.flush()
        self.done += 1
        self.written += 1
        self._write_state()

    def skip_gof(self, gi: int, err: Exception) -> None:
        if self.params.onError == "abort":
            raise err
        self.failures.append({"gof": gi, "error": repr(err)})
        print(f"{self.path_in} GOF {gi}: skipped ({err})", file=sys.stderr)
        self.done += 1
        self._write_state()

    def result(self) -> dict:
        return {
            "stream": self.path_in,
            "gofs": len(self.gofs),
            "failures": len(self.failures),
            "seconds": time.perf_counter() - self.t0,
            "out_bytes": os.path.getsize(self.path_out),
        }


def transcode_stream(
    path_in: str, path_out: str, params: StreamParams, tracer=None
) -> dict:
    """Transcode one stream GOF-by-GOF with checkpointed progress."""
    transcoder = Transcoder(params)

    with _StreamIO(path_in, path_out, params) as sio:

        def process(gi: int):
            context = sio.reader.decode(sio.gofs[gi])
            for atlas in list(context.atlases):
                transcoder.transcode(context, atlas.atlas_id)
            writer = V3CWriter()
            return write_sample_stream_units(writer.encode(context), 4), context

        depth = max(1, params.pipelineDepth)
        with cf.ThreadPoolExecutor(max_workers=depth) as ex:
            futures = {
                gi: ex.submit(process, gi)
                for gi in range(sio.done, len(sio.gofs))
            }
            for gi in sorted(futures):
                try:
                    # pop: a future holds its result until released — keeping
                    # the dict entry would retain every GOF's decoded context
                    # for the whole run instead of O(pipelineDepth)
                    blob, context = futures.pop(gi).result()
                except Exception as e:  # per-GOF failure containment
                    futures.pop(gi, None)
                    sio.skip_gof(gi, e)
                    continue
                if tracer is not None:
                    # same per-GOF emission as rabbit-transcode --trace
                    # (apps/transcode.py): the enc_ side logs come from the
                    # in-memory transcoded context BEFORE serialization, so
                    # diffing them against rabbit-decode --trace on the
                    # written stream catches writer/reader drift.  Emitted
                    # here (ordered, main thread), not in the pipeline
                    # workers, so GOF order in the logs is deterministic.
                    # Keyed by OUTPUT position (sio.written): rabbit-decode
                    # numbers GOFs by position in the written stream, so a
                    # skipped input GOF must not shift every later key.
                    # Emitted BEFORE the write so a crash between the two
                    # re-emits (harmless duplicate) rather than losing the
                    # GOF's trace on resume.
                    from ..codec.patch_frame import decode_patch_frames
                    from ..codec.trace import emit_conformance_traces
                    from ..decoder.decoder import Decoder

                    for atlas in context.atlases:
                        emit_conformance_traces(
                            tracer, atlas, decode_patch_frames(atlas),
                            Decoder().decode(context, atlas.atlas_id),
                            gof=sio.written, atlas_id=atlas.atlas_id,
                        )
                del context  # free the GOF's decoded planes immediately
                sio.write_gof(blob)
        return sio.result()


def transcode_streams_sharded(
    inputs: list[str], outputs: list[str], params: StreamParams
) -> list[dict]:
    """All streams lockstep: each round takes the next pending GOF of every
    stream and transcodes them through ONE mesh-sharded device program
    (transcoder/multistream.py).  Failure containment stays per-stream: a
    stream whose GOF fails to decode is dropped from the round (and skipped
    or aborted per --onError); if the batched call itself fails, the round
    falls back to per-stream transcoding so one poison stream cannot take
    down the others."""
    from ..transcoder.multistream import MultiStreamTranscoder

    mst = MultiStreamTranscoder(params)
    sios = [_StreamIO(i, o, params) for i, o in zip(inputs, outputs)]
    for sio in sios:
        sio.__enter__()
    try:
        while True:
            active = [s for s in sios if s.done < len(s.gofs)]
            if not active:
                break

            def decode_one(sio: _StreamIO):
                return sio.reader.decode(sio.gofs[sio.done])

            contexts: dict[int, object] = {}
            round_sios: list[_StreamIO] = []
            with cf.ThreadPoolExecutor(max_workers=len(active)) as ex:
                futs = {ex.submit(decode_one, s): s for s in active}
                for fu, s in futs.items():
                    try:
                        contexts[id(s)] = fu.result()
                        round_sios.append(s)
                    except Exception as e:
                        s.skip_gof(s.done, e)
            if not round_sios:
                continue
            batch = [contexts[id(s)] for s in round_sios]
            ids = [sios.index(s) for s in round_sios]
            try:
                mst.transcode_many(batch, stream_ids=ids)
                per_stream_fallback = False
            except Exception:
                per_stream_fallback = True
            for s, ctx, sid in zip(round_sios, batch, ids):
                try:
                    if per_stream_fallback:
                        # the failed batch may have partially mutated the
                        # context: re-decode from the original units
                        ctx = s.reader.decode(s.gofs[s.done])
                        tr = mst.single(sid)
                        for atlas in list(ctx.atlases):
                            tr.transcode(ctx, atlas.atlas_id)
                    writer = V3CWriter()
                    blob = write_sample_stream_units(writer.encode(ctx), 4)
                    s.write_gof(blob)
                except Exception as e:
                    s.skip_gof(s.done, e)
    finally:
        for sio in sios:
            sio.__exit__()
    return [s.result() for s in sios]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = StreamParams()
    reg = build_registry(params)
    if parse_or_help(reg, argv, params, "rabbit-stream") is None:
        return 0
    if not params.compressedStreamPath:
        print("error: --compressedStreamPath is required", file=sys.stderr)
        return 1
    inputs = [p for p in params.compressedStreamPath.split(",") if p]
    outputs = (
        [p for p in params.outStreamPath.split(",") if p]
        if "," in params.outStreamPath
        else [
            params.outStreamPath
            if len(inputs) == 1
            else f"{os.path.splitext(params.outStreamPath)[0]}_{i}.bin"
            for i in range(len(inputs))
        ]
    )
    if len(outputs) != len(inputs):
        print("error: input/output stream count mismatch", file=sys.stderr)
        return 1

    tracer = None
    if params.trace:
        if len(inputs) != 1:
            print("warning: --trace supports a single input stream; ignored",
                  file=sys.stderr)
        else:
            from ..utils.tracing import TraceCategory, Tracer

            # on a resumed run, APPEND to the prior run's enc_* logs so the
            # conformance pair still covers every written GOF (truncating
            # here made the crash-resume scenario spuriously fail its own
            # conformance leg); duplicate keys are harmless (same values,
            # last-wins parse)
            resuming = params.resume and os.path.exists(
                _state_path(outputs[0])
            )
            tracer = Tracer(prefix="enc_", append=resuming).enable(
                *TraceCategory
            )

    sw = Stopwatch()
    sw.start()
    results = []
    if len(inputs) == 1:
        results.append(
            transcode_stream(inputs[0], outputs[0], params, tracer=tracer)
        )
        if tracer is not None:
            tracer.close()
    elif params.sharded:
        # one batched, mesh-sharded device program per plane per round
        results.extend(transcode_streams_sharded(inputs, outputs, params))
    else:
        # concurrent streams: threads overlap host entropy with device work
        with cf.ThreadPoolExecutor(max_workers=len(inputs)) as ex:
            futures = [
                ex.submit(transcode_stream, i, o, params)
                for i, o in zip(inputs, outputs)
            ]
            for fu in futures:
                results.append(fu.result())
    sw.stop()
    total_failures = sum(r["failures"] for r in results)
    for r in results:
        print(
            f"{r['stream']}: {r['gofs']} GOFs -> {r['out_bytes']} bytes "
            f"in {r['seconds']:.2f}s ({r['failures']} failures)"
        )
    print_run_footer("rabbit-stream", sw)
    return 0 if total_failures == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
