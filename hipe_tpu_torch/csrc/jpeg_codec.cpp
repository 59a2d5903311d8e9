// Native JPEG codec of hipe_tpu_torch: the host half of the device codec.
// The code is hipe_tpu/csrc/jpeg_codec.cpp's, line for line; only comments
// differ (tests/test_torch_jpeg.py holds the two equal without comments).
// It replaces the reference's vendored CImg image IO (the CImg.h load_jpeg /
// save_jpeg entry points used by heterogeneous_blur.c:106-137). Decodes
// directly to interleaved HWC uint8 (the layout the reference converts to by
// hand, heterogeneous_blur.c:128-135) and encodes back; pthread pools batch
// the decode and the entropy coding for the serving pipeline.
//
// Built as a shared library and bound via ctypes (see hipe_tpu_torch/io_/jpeg.py).

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit_handler(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

}  // namespace

extern "C" {

// Returns 0 on success. Fills w/h/c from the JPEG header.
int hipe_jpeg_dims(const unsigned char* buf, size_t len, int* w, int* h,
                   int* c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  // 4-component streams (Adobe CMYK / YCCK) decode to 4-channel CMYK
  // samples (libjpeg applies the YCCK->CMYK transform itself).
  *c = cinfo.num_components == 4 ? 4 : (cinfo.num_components >= 3 ? 3 : 1);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into caller-allocated out (h*w*c bytes, interleaved HWC).
// Returns 0 on success.
int hipe_jpeg_decode(const unsigned char* buf, size_t len, unsigned char* out,
                     int expect_w, int expect_h, int expect_c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = expect_c == 1   ? JCS_GRAYSCALE
                          : expect_c == 4 ? JCS_CMYK
                                          : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != expect_w ||
      static_cast<int>(cinfo.output_height) != expect_h ||
      static_cast<int>(cinfo.output_components) != expect_c) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const size_t stride = static_cast<size_t>(expect_w) * expect_c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Output dimensions of a scaled decode at scale_num/scale_denom (libjpeg
// normalizes to M/8, M=1..16). Fills w/h/c. Returns 0 on success.
int hipe_jpeg_scaled_dims(const unsigned char* buf, size_t len, int scale_num,
                          int scale_denom, int* w, int* h, int* c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.scale_num = static_cast<unsigned int>(scale_num);
  cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  *c = cinfo.num_components == 4 ? 4 : (cinfo.num_components >= 3 ? 3 : 1);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Scaled decode (libjpeg DCT-domain scaling, scale_num/scale_denom) into
// caller-allocated out (expect_h*expect_w*expect_c bytes, interleaved HWC).
// The golden oracle for the device-side reduced-IDCT decode and the host
// fallback for thumbnail serving. Returns 0 on success, 2 on a dimension
// mismatch (call hipe_jpeg_scaled_dims first).
int hipe_jpeg_decode_scaled(const unsigned char* buf, size_t len,
                            unsigned char* out, int expect_w, int expect_h,
                            int expect_c, int scale_num, int scale_denom) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = expect_c == 1   ? JCS_GRAYSCALE
                          : expect_c == 4 ? JCS_CMYK
                                          : JCS_RGB;
  cinfo.scale_num = static_cast<unsigned int>(scale_num);
  cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != expect_w ||
      static_cast<int>(cinfo.output_height) != expect_h ||
      static_cast<int>(cinfo.output_components) != expect_c) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const size_t stride = static_cast<size_t>(expect_w) * expect_c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Report libjpeg's scaled-decode geometry decisions at scale_num/scale_denom
// without decoding: info[0..1] = output W,H; then per component (up to 4):
// 4 ints {DCT_scaled_size, downsampled_width, downsampled_height, h_samp}.
// This is ground truth for the device reduced-IDCT path — the per-component
// scaled DCT size selection (jdmaster.c) is replicated in Python and
// verified against this probe rather than trusted from documentation.
int hipe_jpeg_scaled_info(const unsigned char* buf, size_t len, int scale_num,
                          int scale_denom, int* info) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components > 4) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.scale_num = static_cast<unsigned int>(scale_num);
  cinfo.scale_denom = static_cast<unsigned int>(scale_denom);
  jpeg_calc_output_dimensions(&cinfo);
  info[0] = static_cast<int>(cinfo.output_width);
  info[1] = static_cast<int>(cinfo.output_height);
  for (int i = 0; i < cinfo.num_components; ++i) {
    jpeg_component_info* comp = &cinfo.comp_info[i];
    int* rec = info + 2 + 4 * i;
    rec[0] = comp->DCT_scaled_size;
    rec[1] = static_cast<int>(comp->downsampled_width);
    rec[2] = static_cast<int>(comp->downsampled_height);
    rec[3] = comp->h_samp_factor;
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode interleaved HWC uint8 to JPEG. Caller provides out buffer of
// capacity out_cap; written length returned in *out_len. Returns 0 on
// success, 3 if the output did not fit — *out_len then holds the required
// size so the caller can retry with an exact-size buffer.
int hipe_jpeg_encode(const unsigned char* img, int w, int h, int c,
                     int quality, unsigned char* out, size_t out_cap,
                     size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * c;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(img) +
                   cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int rc = 0;
  *out_len = mem_len;
  if (mem_len <= out_cap) {
    memcpy(out, mem, mem_len);
  } else {
    rc = 3;  // *out_len reports the needed capacity
  }
  free(mem);
  return rc;
}

// ---- Entropy-only decode: quantized DCT coefficients out ----
//
// The device decode split: the host does only the serial, branchy part
// of JPEG decode (Huffman/arithmetic entropy decoding, via
// jpeg_read_coefficients), and ships quantized DCT coefficient planes to the
// device, where dequantize + IDCT + chroma upsample + YCbCr->RGB run as
// batched code (hipe_tpu_torch/ops/jpeg_decode.py). Replaces the all-host
// decode the reference inherits from CImg (CImg/CImg.h:51770 load_jpeg).

enum {
  INFO_NCOMPS = 0,
  INFO_WIDTH = 1,
  INFO_HEIGHT = 2,
  INFO_MAX_H = 3,
  INFO_MAX_V = 4,
  INFO_PROGRESSIVE = 5,
  INFO_PER_COMP = 6,   // start of per-component records
  COMP_FIELDS = 5,     // h_samp, v_samp, width_in_blocks, height_in_blocks, qno
  INFO_COLOR = 26,     // coded color space (J_COLOR_SPACE: 3=YCbCr,
                       // 4=CMYK, 5=YCCK — decides the device transform)
  INFO_LEN = 6 + 4 * 5 + 1,
};

// Header-only scan of the coefficient geometry. Returns 0 on success.
int hipe_jpeg_coef_info(const unsigned char* buf, size_t len, int* info) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components > 4) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  info[INFO_NCOMPS] = cinfo.num_components;
  info[INFO_WIDTH] = static_cast<int>(cinfo.image_width);
  info[INFO_HEIGHT] = static_cast<int>(cinfo.image_height);
  int max_h = 1, max_v = 1;
  for (int i = 0; i < cinfo.num_components; ++i) {
    if (cinfo.comp_info[i].h_samp_factor > max_h)
      max_h = cinfo.comp_info[i].h_samp_factor;
    if (cinfo.comp_info[i].v_samp_factor > max_v)
      max_v = cinfo.comp_info[i].v_samp_factor;
  }
  info[INFO_MAX_H] = max_h;
  info[INFO_MAX_V] = max_v;
  info[INFO_PROGRESSIVE] = cinfo.progressive_mode ? 1 : 0;
  info[INFO_COLOR] = static_cast<int>(cinfo.jpeg_color_space);
  for (int i = 0; i < cinfo.num_components; ++i) {
    jpeg_component_info* comp = &cinfo.comp_info[i];
    int* rec = info + INFO_PER_COMP + COMP_FIELDS * i;
    rec[0] = comp->h_samp_factor;
    rec[1] = comp->v_samp_factor;
    // width/height_in_blocks are filled by start_decompress normally; for a
    // header-only pass compute them the way jdinput.c does (ceil of the
    // downsampled dimension / DCTSIZE, padded to the MCU grid).
    long wb = ((long)cinfo.image_width * comp->h_samp_factor + 8L * max_h - 1) /
              (8L * max_h);
    long hb = ((long)cinfo.image_height * comp->v_samp_factor + 8L * max_v - 1) /
              (8L * max_v);
    rec[2] = (int)wb;
    rec[3] = (int)hb;
    rec[4] = comp->quant_tbl_no;
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Collect COM and APP1..APP13 markers (Exif, ICC, XMP, comments — the
// jpegtran -copy surface; APP0/JFIF and APP14/Adobe are regenerated by
// the writer, never copied). Serialized into out as repeated
// [int32 marker_code][int32 data_len][data] records. Returns 0 on
// success, 3 if out_cap is too small (*out_len then holds the need).
int hipe_jpeg_read_markers(const unsigned char* buf, size_t len,
                           unsigned char* out, size_t out_cap,
                           size_t* out_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_save_markers(&cinfo, JPEG_COM, 0xFFFF);
  for (int m = 1; m <= 13; ++m)
    jpeg_save_markers(&cinfo, JPEG_APP0 + m, 0xFFFF);
  jpeg_read_header(&cinfo, TRUE);
  size_t need = 0;
  for (jpeg_saved_marker_ptr mk = cinfo.marker_list; mk; mk = mk->next)
    need += 8 + mk->data_length;
  *out_len = need;
  if (need > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  unsigned char* p = out;
  for (jpeg_saved_marker_ptr mk = cinfo.marker_list; mk; mk = mk->next) {
    int code = mk->marker;
    int dlen = static_cast<int>(mk->data_length);
    memcpy(p, &code, 4);
    memcpy(p + 4, &dlen, 4);
    memcpy(p + 8, mk->data, mk->data_length);
    p += 8 + mk->data_length;
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Entropy-decode the whole image (baseline or progressive) and copy the
// quantized coefficients (natural order, as the entropy decoder stores them,
// jdhuff.c) into caller-allocated per-component buffers of
// height_in_blocks * width_in_blocks * 64 int16 each. qtabs receives the
// four quant-table slots (natural order, jdmarker.c get_dqt), 64 uint16
// per slot, zero-filled when absent. Returns 0 on success.
int hipe_jpeg_read_coefs(const unsigned char* buf, size_t len,
                         short* const* comp_out, unsigned short* qtabs) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components > 4) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jvirt_barray_ptr* coef_arrays = jpeg_read_coefficients(&cinfo);
  if (coef_arrays == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  for (int ci = 0; ci < cinfo.num_components; ++ci) {
    jpeg_component_info* comp = &cinfo.comp_info[ci];
    short* dst = comp_out[ci];
    const size_t row_coefs = (size_t)comp->width_in_blocks * DCTSIZE2;
    for (JDIMENSION row = 0; row < comp->height_in_blocks; ++row) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, coef_arrays[ci], row, 1, FALSE);
      memcpy(dst + (size_t)row * row_coefs, rows[0],
             row_coefs * sizeof(short));
    }
  }
  memset(qtabs, 0, 4 * DCTSIZE2 * sizeof(unsigned short));
  for (int n = 0; n < 4; ++n) {
    if (cinfo.quant_tbl_ptrs[n] != nullptr)
      memcpy(qtabs + n * DCTSIZE2, cinfo.quant_tbl_ptrs[n]->quantval,
             DCTSIZE2 * sizeof(unsigned short));
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Shared chroma-subsampling setup for the encode surfaces. Y sampling
// factors per code (chroma stays 1x1 except code 6):
//   0 = leave the libjpeg default 4:2:0 h2v2 in place (callers skip)
//   1 = 4:4:4 (1,1)   2 = 4:2:2 (2,1)   3 = 4:4:0 (1,2)
//   4 = 4:1:1 (4,1)   5 = 4:1:0 (4,2)   7 = 3:1:1 (3,1)
//   6 = mismatched chroma: Y (2,2), Cb (2,1), Cr (1,1) — a legal but
//       exotic layout (decoder picks a different upsampler per
//       component); exists to craft device-decoder test streams.
static void apply_subsamp(jpeg_compress_struct* cinfo, int subsamp) {
  static const int y_factors[8][2] = {
      {2, 2}, {1, 1}, {2, 1}, {1, 2}, {4, 1}, {4, 2}, {2, 2}, {3, 1},
  };
  cinfo->comp_info[0].h_samp_factor = y_factors[subsamp & 7][0];
  cinfo->comp_info[0].v_samp_factor = y_factors[subsamp & 7][1];
  for (int i = 1; i < 3; ++i) {
    cinfo->comp_info[i].h_samp_factor = 1;
    cinfo->comp_info[i].v_samp_factor = 1;
  }
  if (subsamp == 6) {
    cinfo->comp_info[1].h_samp_factor = 2;  // Cb at (2,1): v-only upsample
    cinfo->comp_info[1].v_samp_factor = 1;  // Cr at (1,1): full 2x2 fancy
  }
}

// Encode with explicit chroma subsampling (subsamp codes: see
// apply_subsamp above), optional progressive scan script, optional
// arithmetic entropy coding (arith != 0 => jdarith streams instead of
// Huffman), an optional restart-marker interval (MCUs; 0 = none), and
// optional RGB->grayscale conversion (gray != 0 with c == 3: libjpeg's
// rgb_gray_convert via jpeg_set_colorspace(JCS_GRAYSCALE) — the oracle
// for the device gray-output serving path). Test/bench surface for the
// device-codec paths. Same contract as hipe_jpeg_encode otherwise.
int hipe_jpeg_encode_opts(const unsigned char* img, int w, int h, int c,
                          int quality, int subsamp, int progressive,
                          int arith, int restart_interval, int gray,
                          int optimize,
                          unsigned char* out, size_t out_cap,
                          size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (c == 3 && gray) {
    jpeg_set_colorspace(&cinfo, JCS_GRAYSCALE);
  } else if (c == 3 && subsamp != 0) {
    apply_subsamp(&cinfo, subsamp);
  }
  if (progressive) jpeg_simple_progression(&cinfo);
  if (arith) cinfo.arith_code = TRUE;
  if (optimize) cinfo.optimize_coding = TRUE;
  if (restart_interval > 0)
    cinfo.restart_interval = static_cast<unsigned int>(restart_interval);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * c;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(img) +
                   cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int rc = 0;
  *out_len = mem_len;
  if (mem_len <= out_cap) {
    memcpy(out, mem, mem_len);
  } else {
    rc = 3;  // *out_len reports the needed capacity
  }
  free(mem);
  return rc;
}

// Encode a 4-channel CMYK image (samples passed through as-is; whether
// they follow the Adobe-inverted convention is the caller's concern —
// decode returns the identical values, which is what the device-decode
// byte-identity tests need). ycck != 0 compresses as YCCK (Adobe
// transform 2, subsampled chroma per jpeg_set_colorspace); otherwise
// plain CMYK (transform 0, all components full resolution). Both write
// the Adobe APP14 marker so decoders classify them correctly.
int hipe_jpeg_encode_cmyk(const unsigned char* img, int w, int h,
                          int quality, int ycck, int progressive,
                          unsigned char* out, size_t out_cap,
                          size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 4;
  cinfo.in_color_space = JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  if (ycck) jpeg_set_colorspace(&cinfo, JCS_YCCK);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (progressive) jpeg_simple_progression(&cinfo);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * 4;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(img) +
                   cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int rc = 0;
  *out_len = mem_len;
  if (mem_len <= out_cap) {
    memcpy(out, mem, mem_len);
  } else {
    rc = 3;  // *out_len reports the needed capacity
  }
  free(mem);
  return rc;
}

// The quant tables jpeg_set_quality would install (luma slot 0, chroma
// slot 1; natural order) — the device-side forward quantizer
// (hipe_tpu/ops/jpeg_encode.py) divides by exactly these.
int hipe_jpeg_quality_tables(int quality, unsigned short* qtabs /*2*64*/) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  cinfo.image_width = 8;
  cinfo.image_height = 8;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  for (int n = 0; n < 2; ++n)
    memcpy(qtabs + n * DCTSIZE2, cinfo.quant_tbl_ptrs[n]->quantval,
           DCTSIZE2 * sizeof(unsigned short));
  jpeg_destroy_compress(&cinfo);
  return 0;
}

// Entropy-encode pre-computed quantized DCT coefficients into a full JPEG
// file (the host half of the device encode: the device does color
// conversion, downsampling, forward DCT and quantization —
// hipe_tpu_torch/ops/jpeg_encode.py — and this writes the entropy-coded stream
// via jpeg_write_coefficients, exactly as jpegtran does).
//
// comp_in[i]: height_in_blocks*width_in_blocks*64 int16 (natural order),
// the *unpadded* block grid; MCU-edge dummy blocks are synthesized here
// with the same semantics as the direct encoder (jccoefct.c: zero AC, DC
// duplicated from the neighbor) so the output is byte-identical to a
// direct libjpeg encode of the same pixels. subsamp: 0=4:2:0, 1=4:4:4,
// 3=4:4:0 (h1v2),
// 2=4:2:2 (as hipe_jpeg_encode_opts). Returns 0 on success.
// qt_override: when non-null, 2*64 uint16 quant values in natural order
// (luma table then chroma table) installed verbatim in place of the
// jpeg_set_quality tables — required by lossless transpose-family
// transforms, whose output tables are the transposed input tables.
// markers/markers_len: optional serialized marker records (format of
// hipe_jpeg_read_markers) re-emitted after the frame tables — the
// jpegtran -copy behavior for metadata-preserving lossless transforms.
int hipe_jpeg_write_coefs(int w, int h, int c, int quality, int subsamp,
                          int progressive, int arith, int restart_interval,
                          int optimize, const unsigned short* qt_override,
                          const unsigned char* markers, size_t markers_len,
                          const short* const* comp_in,
                          unsigned char* out, size_t out_cap,
                          size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  unsigned char* mem = nullptr;
  // volatile: assigned between setjmp and a possible longjmp, and must
  // be freed in the handler (a leak per failed call otherwise).
  short* volatile prev_dc = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    if (prev_dc) free(prev_dc);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (c == 3 && subsamp != 0) apply_subsamp(&cinfo, subsamp);
  if (qt_override) {
    for (int t = 0; t < 2 && cinfo.quant_tbl_ptrs[t]; ++t)
      for (int k = 0; k < DCTSIZE2; ++k)
        cinfo.quant_tbl_ptrs[t]->quantval[k] = qt_override[t * DCTSIZE2 + k];
  }
  if (progressive) jpeg_simple_progression(&cinfo);
  if (arith) cinfo.arith_code = TRUE;
  if (optimize) cinfo.optimize_coding = TRUE;
  if (restart_interval > 0)
    cinfo.restart_interval = static_cast<unsigned int>(restart_interval);

  int max_h = 1, max_v = 1;
  for (int i = 0; i < cinfo.num_components; ++i) {
    if (cinfo.comp_info[i].h_samp_factor > max_h)
      max_h = cinfo.comp_info[i].h_samp_factor;
    if (cinfo.comp_info[i].v_samp_factor > max_v)
      max_v = cinfo.comp_info[i].v_samp_factor;
  }
  // Geometry as jdinput.c computes it; arrays padded to the MCU grid.
  jvirt_barray_ptr coef_arrays[4];
  long wbs[4], hbs[4], pad_wbs[4], pad_hbs[4];
  for (int i = 0; i < cinfo.num_components; ++i) {
    jpeg_component_info* comp = &cinfo.comp_info[i];
    wbs[i] = ((long)w * comp->h_samp_factor + 8L * max_h - 1) / (8L * max_h);
    hbs[i] = ((long)h * comp->v_samp_factor + 8L * max_v - 1) / (8L * max_v);
    pad_wbs[i] =
        ((wbs[i] + comp->h_samp_factor - 1) / comp->h_samp_factor) *
        comp->h_samp_factor;
    pad_hbs[i] =
        ((hbs[i] + comp->v_samp_factor - 1) / comp->v_samp_factor) *
        comp->v_samp_factor;
    coef_arrays[i] = (*cinfo.mem->request_virt_barray)(
        (j_common_ptr)&cinfo, JPOOL_IMAGE, FALSE,
        (JDIMENSION)pad_wbs[i], (JDIMENSION)pad_hbs[i],
        (JDIMENSION)comp->v_samp_factor);
  }
  jpeg_write_coefficients(&cinfo, coef_arrays);
  for (const unsigned char* p = markers; p && p < markers + markers_len;) {
    int code, dlen;
    memcpy(&code, p, 4);
    memcpy(&dlen, p + 4, 4);
    jpeg_write_marker(&cinfo, code, p + 8,
                      static_cast<unsigned int>(dlen));
    p += 8 + dlen;
  }
  for (int i = 0; i < cinfo.num_components; ++i) {
    const short* src = comp_in[i];
    const int hs = cinfo.comp_info[i].h_samp_factor;
    // Dummy MCU-edge blocks: zero AC; DC = previous block in MCU scan
    // order, i.e. the left neighbor, or for the first block of a dummy
    // block-row the last block of the previous row in the same MCU
    // (jccoefct.c "DC entries equal to previous block's DC value").
    prev_dc = static_cast<short*>(calloc(pad_wbs[i], sizeof(short)));
    if (!prev_dc) {
      jpeg_destroy_compress(&cinfo);
      if (mem) free(mem);
      return 2;
    }
    for (long row = 0; row < pad_hbs[i]; ++row) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, coef_arrays[i], (JDIMENSION)row, 1, TRUE);
      for (long col = 0; col < pad_wbs[i]; ++col) {
        JCOEFPTR blk = rows[0][col];
        if (row < hbs[i] && col < wbs[i]) {
          memcpy(blk, src + (row * wbs[i] + col) * DCTSIZE2,
                 DCTSIZE2 * sizeof(short));
        } else {
          memset(blk, 0, DCTSIZE2 * sizeof(short));
          blk[0] = (col % hs > 0) ? rows[0][col - 1][0]
                                  : prev_dc[col + hs - 1];
        }
      }
      for (long col = 0; col < pad_wbs[i]; ++col)
        prev_dc[col] = rows[0][col][0];
    }
    free(prev_dc);
    prev_dc = nullptr;
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  int rc = 0;
  *out_len = mem_len;
  if (mem_len <= out_cap) {
    memcpy(out, mem, mem_len);
  } else {
    rc = 3;  // *out_len reports the needed capacity
  }
  free(mem);
  return rc;
}

// ---- Batched multithreaded decode (input pipeline hot path) ----

struct BatchTask {
  const unsigned char* const* bufs;
  const size_t* lens;
  unsigned char* out;      // batch * h*w*c, contiguous
  size_t image_bytes;
  int w, h, c;
  int scale_num, scale_denom;  // 1/1 = full-size decode
  int count;
  int* rcs;                // per-image return codes
  // work queue
  pthread_mutex_t mu;
  int next;
};

void* batch_worker(void* arg) {
  BatchTask* t = static_cast<BatchTask*>(arg);
  for (;;) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->count) break;
    unsigned char* dst = t->out + static_cast<size_t>(i) * t->image_bytes;
    if (t->scale_num == t->scale_denom) {
      t->rcs[i] = hipe_jpeg_decode(t->bufs[i], t->lens[i], dst,
                                   t->w, t->h, t->c);
    } else {
      t->rcs[i] = hipe_jpeg_decode_scaled(t->bufs[i], t->lens[i], dst,
                                          t->w, t->h, t->c,
                                          t->scale_num, t->scale_denom);
    }
  }
  return nullptr;
}

// Decode `count` JPEGs concurrently into one contiguous HWC batch buffer,
// at scale_num/scale_denom (1/1 = full size; w/h/c are the per-image
// expected output dims at that scale). Returns the number of failed images.
int hipe_jpeg_decode_scaled_batch(const unsigned char* const* bufs,
                                  const size_t* lens, int count,
                                  unsigned char* out, int w, int h, int c,
                                  int scale_num, int scale_denom,
                                  int num_threads) {
  BatchTask t;
  t.bufs = bufs;
  t.scale_num = scale_num;
  t.scale_denom = scale_denom;
  t.lens = lens;
  t.out = out;
  t.image_bytes = static_cast<size_t>(w) * h * c;
  t.w = w;
  t.h = h;
  t.c = c;
  t.count = count;
  t.next = 0;
  t.rcs = static_cast<int*>(calloc(count, sizeof(int)));
  pthread_mutex_init(&t.mu, nullptr);

  if (num_threads < 1) num_threads = 1;
  if (num_threads > count) num_threads = count;
  pthread_t* threads =
      static_cast<pthread_t*>(malloc(sizeof(pthread_t) * num_threads));
  for (int i = 0; i < num_threads; ++i)
    pthread_create(&threads[i], nullptr, batch_worker, &t);
  for (int i = 0; i < num_threads; ++i) pthread_join(threads[i], nullptr);

  int failures = 0;
  for (int i = 0; i < count; ++i) failures += (t.rcs[i] != 0);
  free(t.rcs);
  free(threads);
  pthread_mutex_destroy(&t.mu);
  return failures;
}

// Full-size batch decode (original entry point; kept for ABI stability).
int hipe_jpeg_decode_batch(const unsigned char* const* bufs,
                           const size_t* lens, int count, unsigned char* out,
                           int w, int h, int c, int num_threads) {
  return hipe_jpeg_decode_scaled_batch(bufs, lens, count, out, w, h, c,
                                       1, 1, num_threads);
}

// ---- Batched multithreaded entropy coding (serving hot path) ----
//
// The device transcode path (hipe_tpu_torch/runtime/serve.py) keeps only
// the serial entropy stages on the host; these batch entry points run them
// GIL-free on a pthread work queue, replacing per-image ctypes fan-out.
// Same pattern as hipe_jpeg_decode_batch. Replaces (at batch scale) the
// reference's serial host IO loop, heterogeneous_blur.c:106-137.

namespace {

// Generic index work queue: workers pull image indices until drained.
struct WorkQueue {
  pthread_mutex_t mu;
  int next;
  int count;
};

int wq_pull(WorkQueue* q) {
  pthread_mutex_lock(&q->mu);
  int i = q->next++;
  pthread_mutex_unlock(&q->mu);
  return i < q->count ? i : -1;
}

void run_pool(WorkQueue* q, void* arg, int count, int num_threads,
              void* (*worker)(void*)) {
  pthread_mutex_init(&q->mu, nullptr);
  q->next = 0;
  q->count = count;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > count) num_threads = count;
  pthread_t* threads =
      static_cast<pthread_t*>(malloc(sizeof(pthread_t) * num_threads));
  for (int i = 0; i < num_threads; ++i)
    pthread_create(&threads[i], nullptr, worker, arg);
  for (int i = 0; i < num_threads; ++i) pthread_join(threads[i], nullptr);
  free(threads);
  pthread_mutex_destroy(&q->mu);
}

struct InfoBatchTask {
  WorkQueue q;
  const unsigned char* const* bufs;
  const size_t* lens;
  int* infos;  // count * INFO_LEN
  int* rcs;
};

void* info_batch_worker(void* arg) {
  InfoBatchTask* t = static_cast<InfoBatchTask*>(arg);
  for (int i; (i = wq_pull(&t->q)) >= 0;)
    t->rcs[i] = hipe_jpeg_coef_info(t->bufs[i], t->lens[i],
                                    t->infos + (size_t)i * INFO_LEN);
  return nullptr;
}

struct ReadBatchTask {
  WorkQueue q;
  const unsigned char* const* bufs;
  const size_t* lens;
  short* const* comp_ptrs;   // count * 4 pointers (unused slots null)
  unsigned short* qtabs;     // count * 4 * 64
  int* rcs;
};

void* read_batch_worker(void* arg) {
  ReadBatchTask* t = static_cast<ReadBatchTask*>(arg);
  for (int i; (i = wq_pull(&t->q)) >= 0;)
    t->rcs[i] = hipe_jpeg_read_coefs(t->bufs[i], t->lens[i],
                                     t->comp_ptrs + (size_t)i * 4,
                                     t->qtabs + (size_t)i * 4 * DCTSIZE2);
  return nullptr;
}

struct WriteBatchTask {
  WorkQueue q;
  int w, h, c, quality, subsamp, progressive, arith, restart_interval,
      optimize;
  const unsigned short* qt_override;
  const short* const* comp_ptrs;  // count * 4 pointers (unused slots null)
  unsigned char* out;             // count * out_cap
  size_t out_cap;
  size_t* out_lens;
  int* rcs;
};

void* write_batch_worker(void* arg) {
  WriteBatchTask* t = static_cast<WriteBatchTask*>(arg);
  for (int i; (i = wq_pull(&t->q)) >= 0;)
    t->rcs[i] = hipe_jpeg_write_coefs(
        t->w, t->h, t->c, t->quality, t->subsamp, t->progressive,
        t->arith, t->restart_interval, t->optimize, t->qt_override,
        nullptr, 0,
        t->comp_ptrs + (size_t)i * 4, t->out + (size_t)i * t->out_cap,
        t->out_cap, &t->out_lens[i]);
  return nullptr;
}

}  // namespace

// Header-only coefficient geometry for `count` JPEGs concurrently.
// infos: count*INFO_LEN ints; rcs: per-image return codes. Returns the
// number of failed images.
int hipe_jpeg_coef_info_batch(const unsigned char* const* bufs,
                              const size_t* lens, int count, int* infos,
                              int* rcs, int num_threads) {
  InfoBatchTask t;
  t.bufs = bufs;
  t.lens = lens;
  t.infos = infos;
  t.rcs = rcs;
  run_pool(&t.q, &t, count, num_threads, info_batch_worker);
  int failures = 0;
  for (int i = 0; i < count; ++i) failures += (rcs[i] != 0);
  return failures;
}

// Entropy-decode `count` JPEGs concurrently. comp_ptrs is a count*4 table
// of caller-allocated per-component coefficient buffers (geometry from a
// prior coef_info pass; unused component slots may be null). qtabs:
// count*4*64 uint16. Returns the number of failed images.
int hipe_jpeg_read_coefs_batch(const unsigned char* const* bufs,
                               const size_t* lens, int count,
                               short* const* comp_ptrs, unsigned short* qtabs,
                               int* rcs, int num_threads) {
  ReadBatchTask t;
  t.bufs = bufs;
  t.lens = lens;
  t.comp_ptrs = comp_ptrs;
  t.qtabs = qtabs;
  t.rcs = rcs;
  run_pool(&t.q, &t, count, num_threads, read_batch_worker);
  int failures = 0;
  for (int i = 0; i < count; ++i) failures += (rcs[i] != 0);
  return failures;
}

// Entropy-encode `count` coefficient sets sharing one geometry/quality/
// subsampling (the serving group case) concurrently. comp_ptrs: count*4
// pointer table as in the read batch; out: count*out_cap bytes; per-image
// lengths in out_lens (rc 3 => out_lens[i] holds the needed capacity, as
// in hipe_jpeg_write_coefs). Returns the number of failed images.
int hipe_jpeg_write_coefs_batch(int w, int h, int c, int quality, int subsamp,
                                int progressive, int arith,
                                int restart_interval, int optimize,
                                const unsigned short* qt_override,
                                const short* const* comp_ptrs, int count,
                                unsigned char* out, size_t out_cap,
                                size_t* out_lens, int* rcs, int num_threads) {
  WriteBatchTask t;
  t.w = w;
  t.h = h;
  t.c = c;
  t.quality = quality;
  t.subsamp = subsamp;
  t.progressive = progressive;
  t.arith = arith;
  t.restart_interval = restart_interval;
  t.optimize = optimize;
  t.qt_override = qt_override;
  t.comp_ptrs = comp_ptrs;
  t.out = out;
  t.out_cap = out_cap;
  t.out_lens = out_lens;
  t.rcs = rcs;
  run_pool(&t.q, &t, count, num_threads, write_batch_worker);
  int failures = 0;
  for (int i = 0; i < count; ++i) failures += (rcs[i] != 0);
  return failures;
}

}  // extern "C"
