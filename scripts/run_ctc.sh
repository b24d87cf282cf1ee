#!/usr/bin/env bash
# CTC-style rate ladder run (BASELINE config #3): encode once at high
# quality, transcode to r1..r5 with the cfg cascade, decode + metrics per
# rate point.  Mirrors test/runme_linux.sh's cond/rate parameterisation.
#
# Each rate point runs BOTH transcode modes:
#   reencode — drift-free decode->re-encode on device (the baseline, the
#              reference's only option);
#   requant  — the DCT-domain live fast path.
# d1_delta = d1(reencode) - d1(requant) is the north-star quality number
# (target <= 0.05 dB; negative means the live path is better).
set -e
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=${WORK:-./data_ctc}
FRAMES=${FRAMES:-4}
COND=${COND:-ctc-random-access}
SCENE=${SCENE:-sphere}    # sphere | blobs (textured multi-object stress)
mkdir -p "$WORK"

python -m rabbit_transcoding_tpu.testdata --frames "$FRAMES" --scene "$SCENE" \
    --out "$WORK/cloud_%04d.ply"

rabbit-encode \
    --config="$REPO/cfg/common/ctc-common.cfg" \
    --config="$REPO/cfg/condition/$COND.cfg" \
    --uncompressedDataPath="$WORK/cloud_%04d.ply" \
    --frameCount="$FRAMES" \
    --minimumImageWidth=512 \
    --geometryQP=8 --attributeQP=12 --occupancyPrecision=2 \
    --compressedStreamPath="$WORK/hq.bin"

HQ_SIZE=$(stat -c%s "$WORK/hq.bin")
echo "rate;mode;stream_bytes;d1_psnr;d2_psnr;y_psnr" > "$WORK/ladder.csv"
echo "rate;d1_reencode;d1_requant;d1_delta;d1_auto;d1_delta_auto" > "$WORK/delta.csv"
for R in r1 r2 r3 r4 r5; do
    GQP=$(grep geometryQP "$REPO/cfg/rate/ctc-$R.cfg" | cut -d: -f2 | tr -d ' ')
    AQP=$(grep attributeQP "$REPO/cfg/rate/ctc-$R.cfg" | cut -d: -f2 | tr -d ' ')
    OCC=$(grep occupancyPrecision "$REPO/cfg/rate/ctc-$R.cfg" | cut -d: -f2 | tr -d ' ')
    declare -A D1S
    for MODE in reencode requant auto; do
        rabbit-transcode \
            --compressedStreamPath="$WORK/hq.bin" \
            --outStreamPath="$WORK/${R}_$MODE.bin" \
            --geometryQP="$GQP" --attributeQP="$AQP" \
            --occupancyPrecision="$OCC" \
            --mode="$MODE" \
            --test_name="ctc_${R}_$MODE" > "$WORK/${R}_$MODE.log"
        rabbit-decode \
            --compressedStreamPath="$WORK/${R}_$MODE.bin" \
            --reconstructedDataPath="$WORK/${R}_${MODE}_dec_%04d.ply" > /dev/null
        rabbit-metrics \
            --uncompressedDataPath="$WORK/cloud_%04d.ply" \
            --reconstructedDataPath="$WORK/${R}_${MODE}_dec_%04d.ply" \
            --frameCount="$FRAMES" \
            --csvFile="$WORK/${R}_${MODE}_metrics.csv" > /dev/null
        SIZE=$(stat -c%s "$WORK/${R}_$MODE.bin")
        AVG=$(tail -1 "$WORK/${R}_${MODE}_metrics.csv")
        D1=$(echo "$AVG" | cut -d';' -f2)
        D2=$(echo "$AVG" | cut -d';' -f3)
        Y=$(echo "$AVG" | cut -d';' -f5)
        echo "$R;$MODE;$SIZE;$D1;$D2;$Y" >> "$WORK/ladder.csv"
        D1S[$MODE]=$D1
    done
    DELTA=$(python -c "print(f'{${D1S[reencode]} - ${D1S[requant]}:+.4f}')")
    DELTA_AUTO=$(python -c "print(f'{${D1S[reencode]} - ${D1S[auto]}:+.4f}')")
    echo "$R;${D1S[reencode]};${D1S[requant]};$DELTA;${D1S[auto]};$DELTA_AUTO" \
        >> "$WORK/delta.csv"
done
echo "=== rate ladder (input hq.bin: $HQ_SIZE bytes) ==="
awk -F';' '{printf "%-6s %-9s %-14s %-10s %-10s %-10s\n", $1, $2, $3, $4, $5, $6}' \
    "$WORK/ladder.csv"
echo "=== live-vs-baseline D1 delta (target <= 0.05 dB) ==="
awk -F';' '{printf "%-6s %-12s %-12s %-10s %-12s %-10s\n", $1, $2, $3, $4, $5, $6}' \
    "$WORK/delta.csv"
