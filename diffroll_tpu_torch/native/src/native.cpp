// diffroll_tpu_torch native host runtime: the data-path hot loops in C++.
//
// The device path is PyTorch/CUDA; this library covers the host side
// that feeds it (SURVEY.md §2b: the reference's native tier is torchaudio/
// ffmpeg decode + resample, and its per-epoch cost is dominated by the
// dataloader). Exposed through ctypes (diffroll_tpu_torch/native/__init__.py)
// with pure-numpy fallbacks, so the framework runs without a compiler.
//
//   * resample_poly_f32 — polyphase FIR resampler (filter designed host-
//     side in Python; this is the upfirdn inner loop).
//   * rasterize_f32     — note events -> frame/onset piano rolls
//     (reference AudioLoader's MIDI->roll rasterization contract).
//   * extract_notes     — roll -> note events: the sequential onset/offset
//     scan of the eval decoder (reference task/diffusion.py:1185-1233).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// y[j] = sum_k h[k] * x_up[j*down + offset - k], where x_up is x upsampled
// by zero-stuffing factor `up` (zeros outside [0, n_in*up)). `offset` is
// the filter group delay ((n_taps-1)/2), so y is time-aligned with x —
// the scipy.signal.resample_poly contract. Direct polyphase evaluation:
// x index i = (t - k) / up contributes only when (t - k) % up == 0.
void resample_poly_f32(const float* x, int64_t n_in,
                       const float* h, int64_t n_taps,
                       int32_t up, int32_t down, int64_t offset,
                       float* y, int64_t n_out) {
    for (int64_t j = 0; j < n_out; ++j) {
        const int64_t t = j * (int64_t)down + offset;
        double acc = 0.0;
        const int64_t p = t % up;                 // first valid tap offset
        for (int64_t k = p; k < n_taps; k += up) {
            const int64_t i = (t - k) / up;
            if (i < 0) break;                     // further k only decreases i
            if (i < n_in) acc += (double)h[k] * (double)x[i];
        }
        y[j] = (float)acc;
    }
}

// Note events (seconds) -> frame & onset rolls, shape (n_frames, n_pitches),
// row-major float32. fps = sample_rate / hop_length.
void rasterize_f32(const double* onset_s, const double* offset_s,
                   const int32_t* pitch, int64_t n_notes,
                   double fps, int32_t min_midi, int32_t max_midi,
                   float* frame_roll, float* onset_roll,
                   int64_t n_frames, int64_t n_pitches) {
    std::memset(frame_roll, 0, sizeof(float) * n_frames * n_pitches);
    std::memset(onset_roll, 0, sizeof(float) * n_frames * n_pitches);
    for (int64_t n = 0; n < n_notes; ++n) {
        const int32_t key = pitch[n] - min_midi;
        if (key < 0 || pitch[n] > max_midi) continue;
        // half-UP rounding, matching data/rasterize.py (floor(x + 0.5) —
        // consistent under integer frame shifts, unlike half-to-even)
        int64_t f0 = (int64_t)std::floor(onset_s[n] * fps + 0.5);
        int64_t f1 = (int64_t)std::floor(offset_s[n] * fps + 0.5);
        if (f1 <= f0) f1 = f0 + 1;
        if (f0 >= n_frames || f1 <= 0) continue;
        if (0 <= f0 && f0 < n_frames) onset_roll[f0 * n_pitches + key] = 1.f;
        f0 = std::max<int64_t>(f0, 0);
        f1 = std::min<int64_t>(f1, n_frames);
        for (int64_t f = f0; f < f1; ++f)
            frame_roll[f * n_pitches + key] = 1.f;
    }
}

// Roll -> note events. onsets/frames are uint8 (already thresholded),
// shape (T, P) row-major. rule1 requires onset AND frame at the onset
// step; a note runs until the first step where both onset and frame are
// inactive (reference extract_notes_wo_velocity while-loop,
// task/diffusion.py:1208-1231). Returns the number of notes written;
// out_pitch/out_on/out_off must hold up to T*P entries.
int64_t extract_notes(const uint8_t* onsets, const uint8_t* frames,
                      int64_t T, int64_t P, int32_t rule1,
                      int32_t* out_pitch, int32_t* out_on, int32_t* out_off) {
    int64_t n = 0;
    for (int64_t t = 0; t < T; ++t) {
        for (int64_t p = 0; p < P; ++p) {
            const uint8_t on = onsets[t * P + p];
            const uint8_t prev = t > 0 ? onsets[(t - 1) * P + p] : 0;
            if (!(on && !prev)) continue;                 // rising onset edge
            if (rule1 && !frames[t * P + p]) continue;    // require frame too
            int64_t off = t;
            while (off < T && (onsets[off * P + p] || frames[off * P + p]))
                ++off;
            if (off > t) {
                out_pitch[n] = (int32_t)p;
                out_on[n] = (int32_t)t;
                out_off[n] = (int32_t)off;
                ++n;
            }
        }
    }
    return n;
}

}  // extern "C"
