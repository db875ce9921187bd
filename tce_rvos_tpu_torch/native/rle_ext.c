/* Host-side loops of the evaluation path in C (the port's copy of the
 * logic of tce_rvos_tpu/native/rle_ext.c): COCO RLE encode and decode, the
 * counts' string codec, and the boundary map of the DAVIS F-measure.
 *
 * A plain C interface, built with `cc -O3 -shared -fPIC` at first use and
 * called through ctypes (tce_rvos_tpu_torch/native/__init__.py); the
 * caller allocates every output. utils/rle.py and eval/davis_eval.py keep
 * numpy versions of the same functions.
 *
 * Wire format of pycocotools' maskApi.c: column-major runs starting with
 * the zero run; the string codec stores each count after the second as its
 * difference from the count two before, in 5-bit groups with a
 * continuation bit, offset by 48.
 */
#include <stdint.h>
#include <string.h>

/* column-major mask bytes [n] -> counts (capacity n + 1); returns how many */
int64_t tce_rle_encode(const uint8_t *m, int64_t n, int64_t *counts) {
  int64_t k = 0, i = 0;
  uint8_t cur = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && (m[j] != 0) == cur) j++;
    counts[k++] = j - i;
    cur ^= 1;
    i = j;
  }
  if (n == 0) counts[k++] = 0;
  return k;
}

/* counts -> column-major mask bytes [total]; runs past the end are cut */
void tce_rle_decode(const int64_t *counts, int64_t n_counts, uint8_t *out, int64_t total) {
  int64_t pos = 0;
  int val = 0;
  memset(out, 0, (size_t)total);
  for (int64_t i = 0; i < n_counts; i++) {
    int64_t c = counts[i];
    if (pos + c > total) c = total - pos;
    if (val && c > 0) memset(out + pos, 1, (size_t)c);
    pos += c;
    val ^= 1;
  }
}

/* counts -> string (capacity 13 n); returns its length */
int64_t tce_rle_to_string(const int64_t *counts, int64_t n, char *out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    int more = 1;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[pos++] = (char)(c + 48);
    }
  }
  return pos;
}

/* string [slen] -> counts (capacity slen); returns how many, -1 if the
 * string ends inside a count */
int64_t tce_rle_from_string(const char *s, int64_t slen, int64_t *counts) {
  int64_t i = 0, k = 0;
  while (i < slen) {
    int64_t x = 0;
    int b = 0, more = 1;
    while (more) {
      if (i >= slen) return -1;
      int64_t c = (int64_t)s[i] - 48;
      x |= (c & 0x1f) << (5 * b);
      more = (int)(c & 0x20);
      i++;
      if (!more && (c & 0x10)) x |= (int64_t)-1 << (5 * (b + 1));
      b++;
    }
    if (k > 2) x += counts[k - 2];
    counts[k++] = x;
  }
  return k;
}

/* row-major mask [h, w] -> its one-pixel boundary map [h, w] (Martin-style,
 * the same-size path of davis2017's _seg2bmap) */
void tce_seg2bmap(const uint8_t *seg, int64_t h, int64_t w, uint8_t *b) {
  for (int64_t y = 0; y < h; y++) {
    for (int64_t x = 0; x < w; x++) {
      uint8_t s = seg[y * w + x] != 0;
      uint8_t e = (x + 1 < w) ? (seg[y * w + x + 1] != 0) : 0;
      uint8_t so = (y + 1 < h) ? (seg[(y + 1) * w + x] != 0) : 0;
      uint8_t se = (x + 1 < w && y + 1 < h) ? (seg[(y + 1) * w + x + 1] != 0) : 0;
      uint8_t v;
      if (y == h - 1 && x == w - 1) v = 0;
      else if (y == h - 1) v = s ^ e;
      else if (x == w - 1) v = s ^ so;
      else v = (s ^ e) | (s ^ so) | (s ^ se);
      b[y * w + x] = v;
    }
  }
}
