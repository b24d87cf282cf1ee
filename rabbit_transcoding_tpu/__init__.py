"""rabbit_transcoding_tpu — a V-PCC / V3C point-cloud codec + live transcoder
for an accelerator (JAX).

A from-scratch re-design of the capabilities of mic-rud/RABBIT-Transcoding
(MPEG TMC2 v15 + the MMSys'23 RABBIT live V3C transcoder):

 * host (Python/C++) owns bitstream syntax, NAL framing, entropy coding and
   orchestration;
 * the device (JAX/XLA) owns all dense pixel/point math — transforms,
   quantisation, occupancy scaling, patch->3D reprojection, recoloring,
   smoothing, KNN and metrics — batched over (streams x frames x blocks).

Layer map (mirrors SURVEY.md §1, re-architected for the device):

  apps/        CLI entry points (PccApp* analogs)
  transcoder/  live V3C transcoder pipeline           (PccLibTranscoder)
  encoder/     V-PCC encoder pipeline                 (PccLibEncoder)
  decoder/     V-PCC decoder pipeline                 (PccLibDecoder)
  metrics/     D1/D2/color PSNR + checksums           (PccLibMetrics)
  conformance/ trace-log conformance checker          (PccLibConformance)
  video/       video codec abstraction + RBV device codec (PccLibVideo{En,De}coder)
  codec/       shared 3D reconstruction engine        (PCCCodec)
  bitstream/   V3C/atlas syntax + bit I/O             (PccLibBitstream*)
  core/        point sets, images/videos, patches     (PccLibCommon)
  ops/         XLA device kernels
  parallel/    device-mesh sharding of (stream x frame) batches
  utils/       config cascade, tracing, timing
"""

__version__ = "0.1.0"
