// Native host-side image preprocessing of the port's test-mode input
// pipeline (the port's own copy of the fused pass in csrc/preprocess.cpp
// of the JAX package).
//
// One call takes a raw HWC uint8 camera image and produces the
// normalised float32 network input, fusing resize (bilinear), crop,
// horizontal flip and mean/std normalisation in a single pass over
// output pixels. Host C++, built with g++ by
// simpb_tpu_torch/data/native_preprocess.py and bound with ctypes.
// `native_hang` is the watchdog tests' fault injection.

#include <cstdint>
#include <cmath>
#include <ctime>

extern "C" {

// Fault injection for the preemption watchdog (utils/watchdog.py):
// block the calling thread in native code for `seconds`, restarting
// after EINTR, as a stalled native wait on the device does. Python's
// C-level signal handler still runs (it sets the pending flag and
// writes the wakeup fd), but the bytecode loop, and with it the
// Python-level SIGTERM handler, cannot run until this returns.
// Test-only entry point; never called on the training path.
void native_hang(double seconds) {
  struct timespec deadline;
  clock_gettime(CLOCK_MONOTONIC, &deadline);
  deadline.tv_sec += (time_t)seconds;
  deadline.tv_nsec += (long)((seconds - (time_t)seconds) * 1e9);
  if (deadline.tv_nsec >= 1000000000L) {
    deadline.tv_sec += 1;
    deadline.tv_nsec -= 1000000000L;
  }
  for (;;) {
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    if (now.tv_sec > deadline.tv_sec ||
        (now.tv_sec == deadline.tv_sec &&
         now.tv_nsec >= deadline.tv_nsec)) {
      return;
    }
    struct timespec chunk = {0, 50000000L};  // 50 ms, EINTR-restarted
    nanosleep(&chunk, nullptr);
  }
}

// in:  [in_h, in_w, 3] uint8 (RGB)
// out: [out_h, out_w, 3] float32, normalised
// resize: scale factor applied to the source before cropping
// crop_x / crop_y: top-left corner of the crop in resized coords
// flip: mirror horizontally after crop
// mean/std: per-channel normalisation
void resize_crop_flip_normalize(
    const uint8_t* in, int in_h, int in_w,
    float* out, int out_h, int out_w,
    float resize, int crop_x, int crop_y, int flip,
    const float* mean, const float* std_) {
  const float inv_scale = 1.0f / resize;
  const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
  for (int oy = 0; oy < out_h; ++oy) {
    // position in the resized image -> source coords (align_corners=False)
    const float ry = (oy + crop_y + 0.5f) * inv_scale - 0.5f;
    int y0 = (int)std::floor(ry);
    const float ly = ry - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y0 > in_h - 1) y0 = in_h - 1;
    if (y1 < 0) y1 = 0;
    if (y1 > in_h - 1) y1 = in_h - 1;
    for (int ox = 0; ox < out_w; ++ox) {
      const int sx = flip ? (out_w - 1 - ox) : ox;
      const float rx = (sx + crop_x + 0.5f) * inv_scale - 0.5f;
      int x0 = (int)std::floor(rx);
      const float lx = rx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x0 > in_w - 1) x0 = in_w - 1;
      if (x1 < 0) x1 = 0;
      if (x1 > in_w - 1) x1 = in_w - 1;
      const uint8_t* p00 = in + (y0 * in_w + x0) * 3;
      const uint8_t* p01 = in + (y0 * in_w + x1) * 3;
      const uint8_t* p10 = in + (y1 * in_w + x0) * 3;
      const uint8_t* p11 = in + (y1 * in_w + x1) * 3;
      float* o = out + (oy * out_w + ox) * 3;
      const float w00 = (1 - ly) * (1 - lx), w01 = (1 - ly) * lx;
      const float w10 = ly * (1 - lx), w11 = ly * lx;
      for (int ch = 0; ch < 3; ++ch) {
        const float v = w00 * p00[ch] + w01 * p01[ch] + w10 * p10[ch] +
                        w11 * p11[ch];
        o[ch] = (v - mean[ch]) * inv_std[ch];
      }
    }
  }
}

}  // extern "C"
