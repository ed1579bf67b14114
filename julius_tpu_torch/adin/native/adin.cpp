// Native audio-input runtime: level/zero-cross trigger, head/tail margin
// segmenter, DC-offset removal and FIR decimation.
//
// Re-designed from the reference's C adin layer (libsent/src/adin/zc-e.c
// zero-cross counter, adin-cut.c margin logic, zmean.c DC removal,
// ds48to16.c polyphase decimator) as a small self-contained C++ core
// with a C ABI for ctypes.  Per-sample work belongs in native code —
// the Python fallback in frontend/stream.py is ~100x slower and exists
// for environments without a compiler.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <vector>

#include <dlfcn.h>
#include <fcntl.h>
#include <sys/ioctl.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------
// zero-cross / level trigger (reference zc-e.c)
// ---------------------------------------------------------------------

struct ZeroCross {
  int level;
  int zc_thres;
  int win;            // window length in samples
  std::vector<int8_t> ring;
  int pos;
  int zc;
  int sign;
};

void *zc_create(int level, int zc_thres, int window_samples) {
  ZeroCross *z = new ZeroCross();
  z->level = level;
  z->zc_thres = zc_thres;
  z->win = window_samples;
  z->ring.assign(window_samples, 0);
  z->pos = 0;
  z->zc = 0;
  z->sign = 0;
  return z;
}

void zc_free(void *h) { delete static_cast<ZeroCross *>(h); }

void zc_reset(void *h) {
  ZeroCross *z = static_cast<ZeroCross *>(h);
  std::fill(z->ring.begin(), z->ring.end(), 0);
  z->pos = 0;
  z->zc = 0;
  z->sign = 0;
}

// feed samples; writes per-sample trigger flags (0/1) to out
void zc_feed(void *h, const float *s, int n, uint8_t *out) {
  ZeroCross *z = static_cast<ZeroCross *>(h);
  const int lv = z->level;
  for (int i = 0; i < n; i++) {
    int8_t mark = 0;
    const float x = s[i];
    if (x > lv && z->sign <= 0) {
      mark = 1;
      z->sign = 1;
    } else if (x < -lv && z->sign >= 0) {
      mark = -1;
      z->sign = -1;
    }
    const int8_t old = z->ring[z->pos];
    if (old != 0) z->zc--;
    if (mark != 0) z->zc++;
    z->ring[z->pos] = mark;
    z->pos++;
    if (z->pos >= z->win) z->pos = 0;
    out[i] = (z->zc >= z->zc_thres) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------
// ---------------------------------------------------------------------
// Sub-band SNR voice activity detector — the libfvad / WebRTC-VAD role
// (reference adin-cut.c HAVE_LIBFVAD blocks, vendored
// libjulius/libfvad/).  Original design, not a port: six biquad
// band-pass filters (RBJ cosine form) accumulate 10 ms band energies;
// per-band noise floors track minima (fast down, slow up); the frame
// decision sums clipped band log-SNRs against an aggressiveness
// threshold with majority smoothing and hangover.  Defeats the
// level/zero-cross trigger's failure mode: loud but stationary
// broadband noise raises amplitude and crossing counts everywhere,
// while band SNR stays ~0 until structured (speech-like) energy
// appears above the learned floor.
// ---------------------------------------------------------------------

struct Biquad {
  double b0, b1, b2, a1, a2;
  double z1, z2;
  inline double step(double x) {
    double y = b0 * x + z1;
    z1 = b1 * x - a1 * y + z2;
    z2 = b2 * x - a2 * y;
    return y;
  }
};

static void bp_design(Biquad *f, double fc, double q, double fs) {
  double w0 = 2.0 * M_PI * fc / fs;
  double alpha = sin(w0) / (2.0 * q);
  double a0 = 1.0 + alpha;
  f->b0 = alpha / a0;
  f->b1 = 0.0;
  f->b2 = -alpha / a0;
  f->a1 = (-2.0 * cos(w0)) / a0;
  f->a2 = (1.0 - alpha) / a0;
  f->z1 = f->z2 = 0.0;
}

#define FVAD_NB 6

struct FVad {
  Biquad bands[FVAD_NB];
  double e[FVAD_NB];        // running frame energy per band
  double noise[FVAD_NB];    // noise floor per band
  int frame_len;            // samples per decision frame (10 ms)
  int pos;                  // sample position within frame
  int n_frames;             // frames seen (for floor init)
  double thres;             // score threshold (aggressiveness)
  int smooth_n;             // majority window (frames)
  uint8_t hist[16];         // last decisions ring
  int hist_pos;
  int hang, hang_max;       // hangover frames after speech
  uint8_t cur;              // current smoothed decision
};

void *fvad_create(int mode, int sample_rate, int smooth_frames,
                  float thres_offset) {
  FVad *v = new FVad();
  static const double fc[FVAD_NB] = {150, 350, 750, 1500, 2500, 3400};
  for (int b = 0; b < FVAD_NB; b++) {
    bp_design(&v->bands[b], fc[b], 1.2, (double)sample_rate);
    v->e[b] = 0.0;
    v->noise[b] = -1.0;     // uninitialised: seeded from first frames
  }
  v->frame_len = sample_rate / 100;
  v->pos = 0;
  v->n_frames = 0;
  // aggressiveness 0..3 like libfvad modes: higher = stricter
  static const double th[4] = {1.2, 1.8, 2.6, 3.5};
  int m = mode < 0 ? 1 : (mode > 3 ? 3 : mode);
  v->thres = th[m] + (double)thres_offset;
  v->smooth_n = smooth_frames > 0
      ? (smooth_frames > 15 ? 15 : smooth_frames) : 5;
  memset(v->hist, 0, sizeof(v->hist));
  v->hist_pos = 0;
  v->hang = 0;
  v->hang_max = 8;          // 80 ms hangover
  v->cur = 0;
  return v;
}

void fvad_free(void *h) { delete static_cast<FVad *>(h); }

void fvad_reset(void *h) {
  FVad *v = static_cast<FVad *>(h);
  for (int b = 0; b < FVAD_NB; b++) {
    v->bands[b].z1 = v->bands[b].z2 = 0.0;
    v->e[b] = 0.0;
    v->noise[b] = -1.0;
  }
  v->pos = 0;
  v->n_frames = 0;
  memset(v->hist, 0, sizeof(v->hist));
  v->hist_pos = 0;
  v->hang = 0;
  v->cur = 0;
}

// out[i] = 1 where the (smoothed) frame decision says speech
void fvad_feed(void *h, const float *s, int n, uint8_t *out) {
  FVad *v = static_cast<FVad *>(h);
  for (int i = 0; i < n; i++) {
    double x = (double)s[i] / 32768.0;
    for (int b = 0; b < FVAD_NB; b++) {
      double y = v->bands[b].step(x);
      v->e[b] += y * y;
    }
    if (++v->pos >= v->frame_len) {
      // frame decision
      double score = 0.0;
      for (int b = 0; b < FVAD_NB; b++) {
        double e = v->e[b] / v->frame_len + 1e-12;
        if (v->noise[b] < 0.0 || v->n_frames < 3) {
          v->noise[b] = v->noise[b] < 0.0
              ? e : (e < v->noise[b] ? e : v->noise[b]);
        } else if (e < v->noise[b]) {
          v->noise[b] = 0.6 * v->noise[b] + 0.4 * e;   // fast down
        } else {
          v->noise[b] *= 1.006;                        // slow up
        }
        double snr = log10(e / (v->noise[b] + 1e-12));
        if (snr > 0.0) score += (snr > 1.5 ? 1.5 : snr);
        v->e[b] = 0.0;
      }
      v->n_frames++;
      uint8_t raw = score > v->thres ? 1 : 0;
      v->hist[v->hist_pos] = raw;
      v->hist_pos = (v->hist_pos + 1) % v->smooth_n;
      int cnt = 0;
      for (int k = 0; k < v->smooth_n; k++) cnt += v->hist[k];
      if (2 * cnt > v->smooth_n) {
        v->cur = 1;
        v->hang = v->hang_max;
      } else if (v->hang > 0) {
        v->hang--;
        v->cur = 1;
      } else {
        v->cur = 0;
      }
      v->pos = 0;
    }
    out[i] = v->cur;
  }
}

// segmenter with head/tail margins (reference adin-cut.c adin_cut)
// event codes written to ev[]: 0 = silence, 1 = speech-start at this
// sample (head margin handled by caller via start_offset), 2 = in
// speech, 3 = speech-end at this sample
// ---------------------------------------------------------------------

struct Segmenter {
  void *zc;
  void *fvad;         // optional sub-band SNR gate (NULL = off)
  int head;           // head margin samples
  int tail;           // tail margin samples
  int in_speech;
  int silence_run;
};

// fvad_mode < 0 disables the gate (plain level/zero-cross trigger);
// 0..3 = aggressiveness, ANDed with the trigger like the reference's
// libfvad gate over adin-cut detection
void *seg_create2(int level, int zc_thres, int window_samples,
                  int head_samples, int tail_samples,
                  int fvad_mode, int sample_rate, int fvad_smooth,
                  float fvad_thres) {
  Segmenter *g = new Segmenter();
  g->zc = zc_create(level, zc_thres, window_samples);
  g->fvad = fvad_mode >= 0
      ? fvad_create(fvad_mode, sample_rate, fvad_smooth, fvad_thres)
      : nullptr;
  g->head = head_samples;
  g->tail = tail_samples;
  g->in_speech = 0;
  g->silence_run = 0;
  return g;
}

void *seg_create(int level, int zc_thres, int window_samples,
                 int head_samples, int tail_samples) {
  return seg_create2(level, zc_thres, window_samples, head_samples,
                     tail_samples, -1, 16000, 0, 0.0f);
}

void seg_free(void *h) {
  Segmenter *g = static_cast<Segmenter *>(h);
  zc_free(g->zc);
  if (g->fvad) fvad_free(g->fvad);
  delete g;
}

void seg_reset(void *h) {
  Segmenter *g = static_cast<Segmenter *>(h);
  zc_reset(g->zc);
  if (g->fvad) fvad_reset(g->fvad);
  g->in_speech = 0;
  g->silence_run = 0;
}

void seg_feed(void *h, const float *s, int n, uint8_t *ev) {
  Segmenter *g = static_cast<Segmenter *>(h);
  std::vector<uint8_t> trig(n);
  zc_feed(g->zc, s, n, trig.data());
  if (g->fvad) {
    std::vector<uint8_t> voice(n);
    fvad_feed(g->fvad, s, n, voice.data());
    for (int i = 0; i < n; i++) trig[i] = trig[i] && voice[i];
  }
  for (int i = 0; i < n; i++) {
    if (!g->in_speech) {
      if (trig[i]) {
        ev[i] = 1;
        g->in_speech = 1;
        g->silence_run = 0;
      } else {
        ev[i] = 0;
      }
    } else {
      if (trig[i]) {
        g->silence_run = 0;
        ev[i] = 2;
      } else {
        g->silence_run++;
        if (g->silence_run >= g->tail) {
          ev[i] = 3;
          g->in_speech = 0;
          g->silence_run = 0;
        } else {
          ev[i] = 2;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// DC offset removal (reference zmean.c: exponential running mean)
// ---------------------------------------------------------------------

struct ZMean {
  double mean;
  double weight;
  long long count;
};

void *zmean_create() {
  ZMean *m = new ZMean();
  m->mean = 0.0;
  m->weight = 0.0;
  m->count = 0;
  return m;
}

void zmean_free(void *h) { delete static_cast<ZMean *>(h); }

void zmean_feed(void *h, float *s, int n) {
  ZMean *m = static_cast<ZMean *>(h);
  // same semantics as the reference: estimate from a long running sum
  // with a cap so the mean can track slow drift
  const double CAP = 480000.0;   // ~30 s at 16 kHz
  for (int i = 0; i < n; i++) {
    m->mean = (m->mean * m->weight + s[i]) / (m->weight + 1.0);
    if (m->weight < CAP) m->weight += 1.0;
    s[i] -= (float)m->mean;
  }
}

// ---------------------------------------------------------------------
// FIR decimation by an integer factor (the 48->16 kHz role of
// ds48to16.c, generalised: caller supplies the low-pass taps)
// ---------------------------------------------------------------------

struct Decimator {
  std::vector<float> taps;
  std::vector<float> hist;
  int factor;
  int phase;
};

void *dec_create(const float *taps, int n_taps, int factor) {
  Decimator *d = new Decimator();
  d->taps.assign(taps, taps + n_taps);
  d->hist.assign(n_taps, 0.0f);
  d->factor = factor;
  d->phase = 0;
  return d;
}

void dec_free(void *h) { delete static_cast<Decimator *>(h); }

// returns number of output samples written
int dec_feed(void *h, const float *s, int n, float *out) {
  Decimator *d = static_cast<Decimator *>(h);
  const int nt = (int)d->taps.size();
  int m = 0;
  for (int i = 0; i < n; i++) {
    // shift history (small nt; adequate for a front-end)
    std::memmove(d->hist.data() + 1, d->hist.data(),
                 sizeof(float) * (nt - 1));
    d->hist[0] = s[i];
    if (++d->phase == d->factor) {
      d->phase = 0;
      float acc = 0.0f;
      const float *hp = d->hist.data();
      const float *tp = d->taps.data();
      for (int k = 0; k < nt; k++) acc += hp[k] * tp[k];
      out[m++] = acc;
    }
  }
  return m;
}

// ---------------------------------------------------------------------
// microphone capture (reference libsent/src/adin device drivers:
// adin_mic_linux_alsa.c, adin_oss.c, adin_pulseaudio.c).  Sound
// libraries are loaded with dlopen at runtime so the module builds and
// runs on machines without audio stacks; cap_open reports the reason
// when no backend is usable.  All backends deliver mono S16 at the
// requested rate, converted to float32 (same scale as the file path).
// ---------------------------------------------------------------------

struct Capture {
  int kind;           // 0 alsa, 1 pulse, 2 oss
  void *lib;
  void *pcm;          // alsa snd_pcm_t* / pulse pa_simple*
  int fd;             // oss
  // alsa fns
  long (*a_readi)(void *, void *, unsigned long);
  int (*a_recover)(void *, int, int);
  int (*a_close)(void *);
  // pulse fns
  int (*p_read)(void *, void *, size_t, int *);
  void (*p_free)(void *);
};

static void cap_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg);
  }
}

static void *cap_open_alsa(const char *device, int rate,
                           char *err, int errlen) {
  void *lib = dlopen("libasound.so.2", RTLD_NOW);
  if (!lib) lib = dlopen("libasound.so", RTLD_NOW);
  if (!lib) {
    cap_err(err, errlen, "alsa: libasound not found");
    return nullptr;
  }
  int (*open_)(void **, const char *, int, int) =
      (int (*)(void **, const char *, int, int))dlsym(lib, "snd_pcm_open");
  int (*set_params)(void *, int, int, unsigned, unsigned, int, unsigned) =
      (int (*)(void *, int, int, unsigned, unsigned, int, unsigned))
          dlsym(lib, "snd_pcm_set_params");
  if (!open_ || !set_params) {
    cap_err(err, errlen, "alsa: missing symbols");
    dlclose(lib);
    return nullptr;
  }
  void *pcm = nullptr;
  // SND_PCM_STREAM_CAPTURE = 1
  int rc = open_(&pcm, device && *device ? device : "default", 1, 0);
  if (rc < 0) {
    cap_err(err, errlen, "alsa: snd_pcm_open failed");
    dlclose(lib);
    return nullptr;
  }
  // S16_LE = 2, RW_INTERLEAVED = 3, 1ch, soft resample, 500 ms latency
  rc = set_params(pcm, 2, 3, 1, (unsigned)rate, 1, 500000);
  if (rc < 0) {
    int (*close_)(void *) = (int (*)(void *))dlsym(lib, "snd_pcm_close");
    if (close_) close_(pcm);
    cap_err(err, errlen, "alsa: snd_pcm_set_params failed");
    dlclose(lib);
    return nullptr;
  }
  Capture *c = new Capture();
  c->kind = 0;
  c->lib = lib;
  c->pcm = pcm;
  c->fd = -1;
  c->a_readi = (long (*)(void *, void *, unsigned long))
      dlsym(lib, "snd_pcm_readi");
  c->a_recover = (int (*)(void *, int, int))dlsym(lib, "snd_pcm_recover");
  c->a_close = (int (*)(void *))dlsym(lib, "snd_pcm_close");
  return c;
}

static void *cap_open_pulse(const char *device, int rate,
                            char *err, int errlen) {
  void *lib = dlopen("libpulse-simple.so.0", RTLD_NOW);
  if (!lib) lib = dlopen("libpulse-simple.so", RTLD_NOW);
  if (!lib) {
    cap_err(err, errlen, "pulse: libpulse-simple not found");
    return nullptr;
  }
  struct pa_sample_spec { int format; uint32_t rate; uint8_t channels; };
  void *(*new_)(const char *, const char *, int, const char *,
                const char *, const pa_sample_spec *, const void *,
                const void *, int *) =
      (void *(*)(const char *, const char *, int, const char *,
                 const char *, const pa_sample_spec *, const void *,
                 const void *, int *))dlsym(lib, "pa_simple_new");
  if (!new_) {
    cap_err(err, errlen, "pulse: missing symbols");
    dlclose(lib);
    return nullptr;
  }
  pa_sample_spec ss;
  ss.format = 3;  // PA_SAMPLE_S16LE
  ss.rate = (uint32_t)rate;
  ss.channels = 1;
  int e = 0;
  // PA_STREAM_RECORD = 2
  void *s = new_(nullptr, "julius_tpu", 2,
                 device && *device ? device : nullptr,
                 "record", &ss, nullptr, nullptr, &e);
  if (!s) {
    cap_err(err, errlen, "pulse: pa_simple_new failed");
    dlclose(lib);
    return nullptr;
  }
  Capture *c = new Capture();
  c->kind = 1;
  c->lib = lib;
  c->pcm = s;
  c->fd = -1;
  c->p_read = (int (*)(void *, void *, size_t, int *))
      dlsym(lib, "pa_simple_read");
  c->p_free = (void (*)(void *))dlsym(lib, "pa_simple_free");
  return c;
}

static void *cap_open_oss(const char *device, int rate,
                          char *err, int errlen) {
  const char *dev = device && *device ? device : "/dev/dsp";
  int fd = open(dev, O_RDONLY);
  if (fd < 0) {
    cap_err(err, errlen, "oss: cannot open device");
    return nullptr;
  }
  // ioctl numbers from <sys/soundcard.h> (hard-coded so the build has
  // no header dependency): SETFMT 0xC0045005, CHANNELS 0xC0045006,
  // SPEED 0xC0045002; AFMT_S16_LE = 0x10
  int fmt = 0x10, ch = 1, sp = rate;
  if (ioctl(fd, 0xC0045005, &fmt) < 0 || fmt != 0x10 ||
      ioctl(fd, 0xC0045006, &ch) < 0 || ch != 1 ||
      ioctl(fd, 0xC0045002, &sp) < 0 || sp != rate) {
    close(fd);
    cap_err(err, errlen, "oss: device configuration failed");
    return nullptr;
  }
  Capture *c = new Capture();
  c->kind = 2;
  c->lib = nullptr;
  c->pcm = nullptr;
  c->fd = fd;
  return c;
}

void *cap_open(const char *backend, const char *device, int rate,
               char *err, int errlen) {
  cap_err(err, errlen, "");
  if (!backend || !std::strcmp(backend, "alsa"))
    return cap_open_alsa(device, rate, err, errlen);
  if (!std::strcmp(backend, "pulseaudio") || !std::strcmp(backend, "pulse"))
    return cap_open_pulse(device, rate, err, errlen);
  if (!std::strcmp(backend, "oss"))
    return cap_open_oss(device, rate, err, errlen);
  if (!std::strcmp(backend, "auto") || !std::strcmp(backend, "mic")) {
    char e1[128], e2[128], e3[128];
    void *c = cap_open_pulse(device, rate, e1, sizeof(e1));
    if (c) return c;
    c = cap_open_alsa(device, rate, e2, sizeof(e2));
    if (c) return c;
    c = cap_open_oss(device, rate, e3, sizeof(e3));
    if (c) return c;
    if (err && errlen > 0)
      std::snprintf(err, errlen, "%s; %s; %s", e1, e2, e3);
    return nullptr;
  }
  cap_err(err, errlen, "unknown capture backend");
  return nullptr;
}

int cap_read(void *h, float *out, int max_samples) {
  Capture *c = static_cast<Capture *>(h);
  std::vector<int16_t> buf(max_samples);
  long n = -1;
  if (c->kind == 0) {
    n = c->a_readi(c->pcm, buf.data(), (unsigned long)max_samples);
    if (n < 0 && c->a_recover) {
      if (c->a_recover(c->pcm, (int)n, 1) == 0)
        n = c->a_readi(c->pcm, buf.data(), (unsigned long)max_samples);
    }
    if (n < 0) return -1;
  } else if (c->kind == 1) {
    int e = 0;
    if (c->p_read(c->pcm, buf.data(),
                  (size_t)max_samples * sizeof(int16_t), &e) < 0)
      return -1;
    n = max_samples;
  } else {
    long rd = read(c->fd, buf.data(), max_samples * sizeof(int16_t));
    if (rd < 0) return -1;
    n = rd / (long)sizeof(int16_t);
  }
  for (long i = 0; i < n; i++) out[i] = (float)buf[i];
  return (int)n;
}

void cap_close(void *h) {
  Capture *c = static_cast<Capture *>(h);
  if (c->kind == 0 && c->a_close) c->a_close(c->pcm);
  if (c->kind == 1 && c->p_free) c->p_free(c->pcm);
  if (c->kind == 2 && c->fd >= 0) close(c->fd);
  if (c->lib) dlclose(c->lib);
  delete c;
}

}  // extern "C"
