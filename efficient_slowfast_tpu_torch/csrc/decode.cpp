// Native video decode library of the PyTorch port (its own copy of the JAX
// package's csrc/decode.cpp, built with g++ at first use by
// efficient_slowfast_tpu_torch/data/decoder.py into build/torch_decode/).
//
// Replaces the reference's PyAV (Cython/FFmpeg) decode path
// (reference: slowfast/datasets/video_container.py:7-29 and
// slowfast/datasets/decoder.py:150-354) with a C++ library exposed over a
// C ABI for ctypes:
//
//  - selective decode: seek to the clip window's start pts with the same
//    1024-pts margin as pyav_decode_stream (decoder.py:168-189), decode and
//    keep only frames whose pts fall in [start_pts, end_pts];
//  - clip window selection replicates get_start_end_idx + pyav_decode
//    (decoder.py:55-83, :287-354): clip_size = sampling_rate * num_frames /
//    target_fps * fps; random (caller-supplied uniform) or uniformly-spaced
//    test clips;
//  - linspace temporal sampling to num_frames (decoder.py:35-52);
//  - swscale bilinear short-side resize + RGB24 conversion, writing frames
//    into a caller-provided right-padded canvas (short, max_width).
//
// Also provides a tiny mpeg4 encoder (esf_write_test_video) so unit tests can
// synthesize fixture media without external tools.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Frame {
    int64_t pts;
    AVFrame* frame;
};

struct DecodeCtx {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    int stream_idx = -1;

    ~DecodeCtx() {
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
    }
};

int open_video(const char* path, int multi_thread, DecodeCtx* ctx) {
    if (avformat_open_input(&ctx->fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(ctx->fmt, nullptr) < 0) return -2;
    ctx->stream_idx = av_find_best_stream(ctx->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                          nullptr, 0);
    if (ctx->stream_idx < 0) return -3;
    AVStream* st = ctx->fmt->streams[ctx->stream_idx];
    const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) return -4;
    ctx->dec = avcodec_alloc_context3(codec);
    if (!ctx->dec) return -5;
    if (avcodec_parameters_to_context(ctx->dec, st->codecpar) < 0) return -6;
    if (multi_thread) {
        // PyAV's thread_type="AUTO" equivalent (video_container.py:23-27)
        ctx->dec->thread_count = 0;
        ctx->dec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    }
    if (avcodec_open2(ctx->dec, codec, nullptr) < 0) return -7;
    return 0;
}

// Decode every frame with pts in [start_pts, end_pts] after seeking with the
// reference's margin (decoder.py:168-189). Frames returned sorted by pts.
int decode_window(DecodeCtx* ctx, int64_t start_pts, int64_t end_pts,
                  int64_t margin, std::vector<Frame>* out) {
    int64_t seek_target = std::max<int64_t>(start_pts - margin, 0);
    av_seek_frame(ctx->fmt, ctx->stream_idx, seek_target, AVSEEK_FLAG_BACKWARD);
    avcodec_flush_buffers(ctx->dec);

    AVPacket* pkt = av_packet_alloc();
    AVFrame* frm = av_frame_alloc();
    bool done = false;
    int max_margin_overrun = 0;
    while (!done) {
        int r = av_read_frame(ctx->fmt, pkt);
        bool eof_input = (r < 0);
        if (!eof_input && pkt->stream_index != ctx->stream_idx) {
            av_packet_unref(pkt);
            continue;
        }
        if (avcodec_send_packet(ctx->dec, eof_input ? nullptr : pkt) < 0 &&
            !eof_input) {
            av_packet_unref(pkt);
            continue;
        }
        av_packet_unref(pkt);
        while (true) {
            int rr = avcodec_receive_frame(ctx->dec, frm);
            if (rr == AVERROR(EAGAIN)) break;
            if (rr == AVERROR_EOF) { done = true; break; }
            if (rr < 0) { done = true; break; }
            int64_t pts = frm->best_effort_timestamp;
            if (pts == AV_NOPTS_VALUE) pts = frm->pts;
            if (pts > end_pts) {
                // a little overrun keeps b-frame reordering safe, then stop
                if (++max_margin_overrun > 8) { done = true; }
            }
            if (pts >= start_pts && pts <= end_pts) {
                Frame f;
                f.pts = pts;
                f.frame = av_frame_clone(frm);
                out->push_back(f);
            }
            av_frame_unref(frm);
        }
        if (eof_input) break;
    }
    av_packet_free(&pkt);
    av_frame_free(&frm);
    std::sort(out->begin(), out->end(),
              [](const Frame& a, const Frame& b) { return a.pts < b.pts; });
    return out->empty() ? -1 : 0;
}

// Output geometry shared by esf_decode_clip2 and esf_decode_views: short
// side == short_side, preserve aspect, center-crop the long side to the
// canvas limits; portrait content optionally written transposed (keep_tall).
struct OutGeom {
    int new_w = 0, new_h = 0;   // swscale target size
    int portrait = 0;
    int crop_w = 0, crop_h = 0; // canvas content extent (crop_h == short)
    int x_off = 0, y_off = 0;   // crop origin within the scaled frame
};

OutGeom compute_geom(int in_w, int in_h, int short_side, int max_width,
                     int keep_tall) {
    OutGeom g;
    if (in_h <= in_w) {
        g.new_h = short_side;
        g.new_w = std::max(short_side,
                           int(std::lround(double(in_w) * short_side / in_h)));
    } else {
        g.new_w = short_side;
        g.new_h = int(std::lround(double(in_h) * short_side / in_w));
    }
    g.portrait = (keep_tall && in_h > in_w && g.new_h > short_side) ? 1 : 0;
    if (g.portrait) {
        // transposed write: canvas rows = source columns (== short_side),
        // canvas cols = source rows (vertical extent, center-cropped)
        g.crop_h = g.new_w;                       // == short_side
        g.crop_w = std::min(g.new_h, max_width);  // source vertical extent
        g.x_off = 0;
        g.y_off = (g.new_h - g.crop_w) / 2;
    } else {
        g.crop_w = std::min(g.new_w, max_width);
        g.crop_h = std::min(g.new_h, short_side);
        g.x_off = (g.new_w - g.crop_w) / 2;
        g.y_off = (g.new_h - g.crop_h) / 2;
    }
    return g;
}

// Write one scaled RGB frame into its canvas slot (content + zeroed column
// tail; every row of the slot is written — the np.empty contract).
void write_canvas_frame(const uint8_t* rgb, const OutGeom& g, int max_width,
                        uint8_t* dst) {
    size_t row_bytes = size_t(max_width) * 3;
    size_t pad_bytes = size_t(max_width - g.crop_w) * 3;
    if (g.portrait) {
        for (int x = 0; x < g.crop_h; ++x) {
            uint8_t* orow = dst + size_t(x) * row_bytes;
            for (int y = 0; y < g.crop_w; ++y) {
                const uint8_t* p =
                    rgb + (size_t(y + g.y_off) * g.new_w + x) * 3;
                orow[size_t(y) * 3 + 0] = p[0];
                orow[size_t(y) * 3 + 1] = p[1];
                orow[size_t(y) * 3 + 2] = p[2];
            }
            if (pad_bytes)
                std::memset(orow + size_t(g.crop_w) * 3, 0, pad_bytes);
        }
    } else {
        for (int y = 0; y < g.crop_h; ++y) {
            uint8_t* orow = dst + size_t(y) * row_bytes;
            const uint8_t* src =
                rgb + (size_t(y + g.y_off) * g.new_w + g.x_off) * 3;
            std::memcpy(orow, src, size_t(g.crop_w) * 3);
            if (pad_bytes)
                std::memset(orow + size_t(g.crop_w) * 3, 0, pad_bytes);
        }
    }
}

}  // namespace

extern "C" {

// Decode one clip. Returns 0 on success, negative error code otherwise.
//   path          video file
//   num_frames    frames to return (after linspace sampling)
//   sampling_rate, target_fps  reference clip-window params
//   clip_idx      -1 = random window (uses random01), else test clip index
//   num_clips     number of uniformly spaced test clips
//   random01      uniform sample in [0,1) used when clip_idx == -1
//   short_side    output short side (swscale bilinear)
//   max_width     output canvas width; wider content is center-cropped
//   multi_thread  enable frame/slice threading
//   out           buffer of num_frames * short_side * max_width * 3 bytes
//   out_width     receives the true content width (<= max_width)
//   keep_tall     (clip2) when nonzero, portrait (h > w) content is written
//                 TRANSPOSED into the landscape canvas instead of being
//                 center-cropped square: canvas rows = source columns
//                 (short side), canvas cols = source rows (vertical extent,
//                 center-cropped to max_width). The Python wrapper swaps the
//                 axes back (a zero-copy view) so callers always receive
//                 frames in natural orientation — this preserves the full
//                 vertical extent the reference's 3-position tall-video test
//                 protocol needs (slowfast/datasets/transform.py:425-468).
//   out_portrait  (clip2) receives 1 when the transposed path was taken
int esf_decode_clip2(const char* path, int num_frames, double sampling_rate,
                     double target_fps, int clip_idx, int num_clips,
                     double random01, int short_side, int max_width,
                     int multi_thread, int keep_tall, unsigned char* out,
                     int* out_width, int* out_portrait) {
    DecodeCtx ctx;
    int rc = open_video(path, multi_thread, &ctx);
    if (rc != 0) return rc;

    AVStream* st = ctx.fmt->streams[ctx.stream_idx];
    double fps = av_q2d(st->avg_frame_rate);
    if (!(fps > 0)) fps = av_q2d(st->r_frame_rate);
    if (!(fps > 0)) fps = 30.0;
    int64_t frames_length = st->nb_frames;
    int64_t duration = st->duration;

    std::vector<Frame> window;
    double start_idx = 0.0, end_idx = 0.0;
    double clip_size = sampling_rate * num_frames / target_fps * fps;
    bool selective = (duration > 0 && frames_length > 0);

    if (selective) {
        double delta = std::max<double>(frames_length - clip_size, 0);
        if (clip_idx == -1) {
            start_idx = delta * random01;
        } else {
            start_idx = delta * clip_idx / std::max(num_clips, 1);
        }
        end_idx = start_idx + clip_size - 1;
        double timebase = double(duration) / double(frames_length);
        int64_t start_pts = int64_t(start_idx * timebase);
        int64_t end_pts = int64_t(end_idx * timebase);
        rc = decode_window(&ctx, start_pts, end_pts, 1024, &window);
    } else {
        rc = decode_window(&ctx, 0, INT64_MAX / 2, 0, &window);
    }
    if (rc != 0 || window.empty()) {
        for (auto& f : window) av_frame_free(&f.frame);
        return -10;
    }

    // second-stage temporal sampling (decoder.py:357-470): when the decode
    // was selective the window IS the clip → sample over the whole window;
    // otherwise sample the clip range out of the full video.
    int n = int(window.size());
    double sel_start, sel_end;
    if (selective) {
        sel_start = 0;
        sel_end = n - 1;
    } else {
        double delta = std::max<double>(n - clip_size, 0);
        if (clip_idx == -1) sel_start = delta * random01;
        else sel_start = delta * clip_idx / std::max(num_clips, 1);
        sel_end = sel_start + clip_size - 1;
    }

    // output geometry: short side == short_side, preserve aspect, center-crop
    // long side to canvas limits (compute_geom; portrait → transposed write,
    // see the keep_tall doc above)
    int in_w = ctx.dec->width, in_h = ctx.dec->height;
    OutGeom g = compute_geom(in_w, in_h, short_side, max_width, keep_tall);
    if (out_portrait) *out_portrait = g.portrait;
    *out_width = g.crop_w;

    // Contract with the Python side (data/decoder.py uses np.empty): on
    // success EVERY byte of the buffer is written — crop_h content rows
    // spanning all short_side rows, plus per-row zeroed column tails. If a
    // future geometry change breaks that (crop_h < short_side), fail loudly
    // here instead of leaking uninitialized heap into model inputs.
    if (g.crop_h != short_side || g.crop_w > max_width) {
        for (auto& f : window) av_frame_free(&f.frame);
        return -13;
    }

    SwsContext* sws = sws_getContext(
        in_w, in_h, ctx.dec->pix_fmt, g.new_w, g.new_h, AV_PIX_FMT_RGB24,
        SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws) {
        for (auto& f : window) av_frame_free(&f.frame);
        return -11;
    }

    std::vector<uint8_t> rgb(size_t(g.new_w) * g.new_h * 3);
    uint8_t* dst_data[4] = {rgb.data(), nullptr, nullptr, nullptr};
    int dst_linesize[4] = {g.new_w * 3, 0, 0, 0};

    // Right-pad (columns >= crop_w) is zeroed per row inside
    // write_canvas_frame instead of a whole-buffer memset: content rows
    // always span all short_side rows (crop_h == short_side, checked
    // above), so only the column tail needs zeroing — a whole-buffer pass
    // costs ~6% of decode time at canvas sizes (3.15 ms / 12.6 MB buffer,
    // PERF.md r4) and doubles for the test loader's wide (4:1) buffers.
    size_t frame_bytes = size_t(short_side) * size_t(max_width) * 3;

    for (int i = 0; i < num_frames; ++i) {
        double pos = (num_frames == 1)
                         ? sel_start
                         : sel_start + (sel_end - sel_start) * i / (num_frames - 1);
        int idx = int(std::lround(pos));
        idx = std::min(std::max(idx, 0), n - 1);
        AVFrame* f = window[size_t(idx)].frame;
        sws_scale(sws, f->data, f->linesize, 0, in_h, dst_data, dst_linesize);
        write_canvas_frame(rgb.data(), g, max_width,
                           out + size_t(i) * frame_bytes);
    }

    sws_freeContext(sws);
    for (auto& f : window) av_frame_free(&f.frame);
    return 0;
}

// Decode ALL num_clips uniformly-spaced test views of one video at once.
//
// The 30-view protocol's temporal windows overlap heavily (each spans
// clip_size frames of the same video at strides of (L - clip_size) /
// num_clips), so per-view selective decodes re-decode the same content up
// to ~10×. This entry instead makes two sequential passes:
//   pass A decodes the stream once collecting only frame pts, from which
//   every view's window ([start_pts, end_pts] filter — the same int math
//   as esf_decode_clip2's selective branch) and linspace selection
//   (decoder.py:35-52 semantics) are computed exactly;
//   pass B decodes once more, scales each SELECTED frame a single time,
//   and writes it into every (view, slot) that chose it.
// Output is bit-identical to num_clips independent esf_decode_clip2 calls
// (tests/test_decoder.py) at ~2 full decodes instead of num_clips window
// decodes, and with deduplicated swscale work.
//
// Length guard: the union's win comes entirely from WINDOW OVERLAP
// (stride (L - clip_size)/num_clips < clip_size, i.e. L < clip_size *
// (num_clips + 1)). On longer seekable media the two full passes lose to
// num_clips cheap seek+window decodes (measured warm: union ~2-3x slower
// at 2400 frames, ~2-3x faster at <=300 — PERF.md r5), so a seekable
// stream past that bound returns -16 BEFORE pass A and the caller decodes
// per view. Streams WITHOUT seek metadata are exempt: per-view decoding
// then degrades to num_clips full scans (decode_window's non-seekable
// branch), which the union's two passes always beat.
//
//   out: num_clips * num_frames * short_side * max_width * 3 bytes.
// Returns 0 on success; -14 when the stream has duplicate frame pts
// (pts-keyed pass-B matching would be ambiguous — caller falls back to
// per-view decodes); -16 when the length guard bails (caller falls back);
// other negative codes as esf_decode_clip2.
int esf_decode_views(const char* path, int num_frames, double sampling_rate,
                     double target_fps, int num_clips, int short_side,
                     int max_width, int multi_thread, int keep_tall,
                     unsigned char* out, int* out_width, int* out_portrait) {
    // ---- pass A: pts scan (full decode, no clone, no scale) ----
    std::vector<int64_t> all_pts;
    int in_w = 0, in_h = 0;
    AVPixelFormat pix_fmt = AV_PIX_FMT_NONE;
    double fps = 30.0;
    int64_t frames_length = 0, duration = 0;
    {
        DecodeCtx ctx;
        int rc = open_video(path, multi_thread, &ctx);
        if (rc != 0) return rc;
        AVStream* st = ctx.fmt->streams[ctx.stream_idx];
        fps = av_q2d(st->avg_frame_rate);
        if (!(fps > 0)) fps = av_q2d(st->r_frame_rate);
        if (!(fps > 0)) fps = 30.0;
        frames_length = st->nb_frames;
        duration = st->duration;
        in_w = ctx.dec->width;
        in_h = ctx.dec->height;
        pix_fmt = ctx.dec->pix_fmt;

        // length guard (see header comment): seekable media whose view
        // windows cannot overlap (L >= clip * (num_clips + 1)) decodes
        // faster per view — bail before paying the pass-A full decode.
        // Warm-page-measured crossovers sit at the bound on BOTH GOP-8
        // and GOP-250 media (PERF.md r5: 600f GOP-250 union 0.50 s vs
        // seeks 0.55 s; 1200f GOP-250 union 0.67 s vs seeks 0.55 s), so
        // the overlap bound alone is the right rule — a GOP-aware
        // extension calibrated on this host's first-touch page-fault
        // artifact engaged union in a region where it slightly loses and
        // was reverted.
        if (duration > 0 && frames_length > 0) {
            double clip = sampling_rate * num_frames / target_fps * fps;
            if (double(frames_length) >= clip * (num_clips + 1))
                return -16;
        }

        AVPacket* pkt = av_packet_alloc();
        AVFrame* frm = av_frame_alloc();
        bool done = false;
        while (!done) {
            int r = av_read_frame(ctx.fmt, pkt);
            bool eof_input = (r < 0);
            if (!eof_input && pkt->stream_index != ctx.stream_idx) {
                av_packet_unref(pkt);
                continue;
            }
            if (avcodec_send_packet(ctx.dec, eof_input ? nullptr : pkt) < 0 &&
                !eof_input) {
                av_packet_unref(pkt);
                continue;
            }
            av_packet_unref(pkt);
            while (true) {
                int rr = avcodec_receive_frame(ctx.dec, frm);
                if (rr == AVERROR(EAGAIN)) break;
                if (rr < 0) { done = true; break; }
                int64_t pts = frm->best_effort_timestamp;
                if (pts == AV_NOPTS_VALUE) pts = frm->pts;
                all_pts.push_back(pts);
                av_frame_unref(frm);
            }
            if (eof_input) break;
        }
        av_packet_free(&pkt);
        av_frame_free(&frm);
    }
    if (all_pts.empty()) return -10;
    std::sort(all_pts.begin(), all_pts.end());
    for (size_t i = 1; i < all_pts.size(); ++i)
        if (all_pts[i] == all_pts[i - 1]) return -14;  // ambiguous pts match
    int n_total = int(all_pts.size());

    OutGeom g = compute_geom(in_w, in_h, short_side, max_width, keep_tall);
    if (out_portrait) *out_portrait = g.portrait;
    *out_width = g.crop_w;
    if (g.crop_h != short_side || g.crop_w > max_width) return -13;

    // ---- per-view window + linspace selection (esf_decode_clip2 math) ----
    double clip_size = sampling_rate * num_frames / target_fps * fps;
    bool selective = (duration > 0 && frames_length > 0);
    size_t frame_bytes = size_t(short_side) * size_t(max_width) * 3;
    // pts → list of output slots (view * num_frames + i)
    std::vector<std::pair<int64_t, int>> want;  // (pts, slot)
    for (int v = 0; v < num_clips; ++v) {
        int first = 0, count = n_total;
        double sel_start, sel_end;
        if (selective) {
            double delta = std::max<double>(frames_length - clip_size, 0);
            double start_idx = delta * v / std::max(num_clips, 1);
            double end_idx = start_idx + clip_size - 1;
            double timebase = double(duration) / double(frames_length);
            int64_t start_pts = int64_t(start_idx * timebase);
            int64_t end_pts = int64_t(end_idx * timebase);
            // window = frames with pts in [start_pts, end_pts] (sorted)
            first = int(std::lower_bound(all_pts.begin(), all_pts.end(),
                                         start_pts) - all_pts.begin());
            int last = int(std::upper_bound(all_pts.begin(), all_pts.end(),
                                            end_pts) - all_pts.begin());
            count = last - first;
            if (count <= 0) return -10;  // empty window, as esf_decode_clip2
            sel_start = 0;
            sel_end = count - 1;
        } else {
            double delta = std::max<double>(n_total - clip_size, 0);
            sel_start = delta * v / std::max(num_clips, 1);
            sel_end = sel_start + clip_size - 1;
        }
        for (int i = 0; i < num_frames; ++i) {
            double pos = (num_frames == 1)
                             ? sel_start
                             : sel_start +
                                   (sel_end - sel_start) * i / (num_frames - 1);
            int idx = int(std::lround(pos));
            idx = std::min(std::max(idx, 0), count - 1);
            want.emplace_back(all_pts[size_t(first + idx)],
                              v * num_frames + i);
        }
    }
    std::sort(want.begin(), want.end());

    // ---- pass B: decode again, scale each needed frame once ----
    DecodeCtx ctx;
    int rc = open_video(path, multi_thread, &ctx);
    if (rc != 0) return rc;
    SwsContext* sws = sws_getContext(
        in_w, in_h, pix_fmt, g.new_w, g.new_h, AV_PIX_FMT_RGB24,
        SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!sws) return -11;
    std::vector<uint8_t> rgb(size_t(g.new_w) * g.new_h * 3);
    uint8_t* dst_data[4] = {rgb.data(), nullptr, nullptr, nullptr};
    int dst_linesize[4] = {g.new_w * 3, 0, 0, 0};

    size_t filled = 0;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frm = av_frame_alloc();
    bool done = false;
    while (!done && filled < want.size()) {
        int r = av_read_frame(ctx.fmt, pkt);
        bool eof_input = (r < 0);
        if (!eof_input && pkt->stream_index != ctx.stream_idx) {
            av_packet_unref(pkt);
            continue;
        }
        if (avcodec_send_packet(ctx.dec, eof_input ? nullptr : pkt) < 0 &&
            !eof_input) {
            av_packet_unref(pkt);
            continue;
        }
        av_packet_unref(pkt);
        while (filled < want.size()) {
            int rr = avcodec_receive_frame(ctx.dec, frm);
            if (rr == AVERROR(EAGAIN)) break;
            if (rr < 0) { done = true; break; }
            int64_t pts = frm->best_effort_timestamp;
            if (pts == AV_NOPTS_VALUE) pts = frm->pts;
            auto lo = std::lower_bound(
                want.begin(), want.end(), std::make_pair(pts, -1));
            if (lo != want.end() && lo->first == pts) {
                sws_scale(sws, frm->data, frm->linesize, 0, in_h, dst_data,
                          dst_linesize);
                for (auto it = lo; it != want.end() && it->first == pts;
                     ++it) {
                    write_canvas_frame(rgb.data(), g, max_width,
                                       out + size_t(it->second) * frame_bytes);
                    ++filled;
                }
            }
            av_frame_unref(frm);
        }
        if (eof_input) break;
    }
    av_packet_free(&pkt);
    av_frame_free(&frm);
    sws_freeContext(sws);
    return filled == want.size() ? 0 : -15;  // pass B missed a frame
}

// Original ABI: tall content center-cropped square (pre-r4 behavior).
int esf_decode_clip(const char* path, int num_frames, double sampling_rate,
                    double target_fps, int clip_idx, int num_clips,
                    double random01, int short_side, int max_width,
                    int multi_thread, unsigned char* out, int* out_width) {
    int portrait = 0;
    return esf_decode_clip2(path, num_frames, sampling_rate, target_fps,
                            clip_idx, num_clips, random01, short_side,
                            max_width, multi_thread, /*keep_tall=*/0, out,
                            out_width, &portrait);
}

// Probe basic stream info. Returns 0 on success.
int esf_probe(const char* path, double* fps, int64_t* nb_frames,
              int* width, int* height) {
    DecodeCtx ctx;
    int rc = open_video(path, 0, &ctx);
    if (rc != 0) return rc;
    AVStream* st = ctx.fmt->streams[ctx.stream_idx];
    *fps = av_q2d(st->avg_frame_rate);
    *nb_frames = st->nb_frames;
    *width = ctx.dec->width;
    *height = ctx.dec->height;
    return 0;
}

// ---------------------------------------------------------------------------
// Sequential canvas-frame stream: open once, pull one scaled canvas frame
// per call, close. This is the demo file path's decode substrate
// (engine/demo.py file_window_stream): consecutive sliding windows decoded
// through per-window seeks pay a keyframe backoff of up to a full GOP
// (~250 frames on typical x264 media) per ~64-frame window; a sequential
// stream decodes every frame exactly once, like the reference's cv2 read
// loop (tools/demo_net.py:156-172). Geometry (compute_geom /
// write_canvas_frame) matches esf_decode_clip2 exactly, so a streamed
// frame is byte-identical to the same frame from a window decode.

struct StreamCtx {
    DecodeCtx ctx;
    SwsContext* sws = nullptr;
    std::vector<uint8_t> rgb;
    OutGeom g;
    int max_width = 0;
    AVPacket* pkt = nullptr;
    AVFrame* frm = nullptr;
    bool input_eof = false;

    ~StreamCtx() {
        if (sws) sws_freeContext(sws);
        if (pkt) av_packet_free(&pkt);
        if (frm) av_frame_free(&frm);
    }
};

// Returns a handle (nullptr on failure, *err holds the open_video code).
// out_width/out_portrait: canvas geometry, as esf_decode_clip2.
void* esf_stream_open(const char* path, int multi_thread, int short_side,
                      int max_width, int keep_tall, double* fps,
                      int64_t* nb_frames, int64_t* duration, int* out_width,
                      int* out_portrait, int* err) {
    auto* s = new StreamCtx();
    int rc = open_video(path, multi_thread, &s->ctx);
    if (rc != 0) {
        if (err) *err = rc;
        delete s;
        return nullptr;
    }
    AVStream* st = s->ctx.fmt->streams[s->ctx.stream_idx];
    double f = av_q2d(st->avg_frame_rate);
    if (!(f > 0)) f = av_q2d(st->r_frame_rate);
    if (fps) *fps = f;
    if (nb_frames) *nb_frames = st->nb_frames;
    if (duration) *duration = st->duration;

    s->max_width = max_width;
    s->g = compute_geom(s->ctx.dec->width, s->ctx.dec->height, short_side,
                        max_width, keep_tall);
    if (out_width) *out_width = s->g.crop_w;
    if (out_portrait) *out_portrait = s->g.portrait;
    if (s->g.crop_h != short_side || s->g.crop_w > max_width) {
        if (err) *err = -13;  // np.empty contract, as esf_decode_clip2
        delete s;
        return nullptr;
    }
    s->sws = sws_getContext(s->ctx.dec->width, s->ctx.dec->height,
                            s->ctx.dec->pix_fmt, s->g.new_w, s->g.new_h,
                            AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr,
                            nullptr);
    if (!s->sws) {
        if (err) *err = -11;
        delete s;
        return nullptr;
    }
    s->rgb.resize(size_t(s->g.new_w) * s->g.new_h * 3);
    s->pkt = av_packet_alloc();
    s->frm = av_frame_alloc();
    if (err) *err = 0;
    return s;
}

// Pull the next frame into `out` (short_side * max_width * 3 bytes, the
// same canvas layout as one esf_decode_clip2 frame slot) and its pts into
// *out_pts. Returns 0 on a frame, 1 on end of stream, and the negative
// FFmpeg error code where a packet fails to read or decode mid-stream
// (never 1 there: a caller must not take a broken stream for a short one).
int esf_stream_next(void* handle, unsigned char* out, long long* out_pts) {
    auto* s = static_cast<StreamCtx*>(handle);
    while (true) {
        int rr = avcodec_receive_frame(s->ctx.dec, s->frm);
        if (rr == 0) {
            int64_t pts = s->frm->best_effort_timestamp;
            if (pts == AV_NOPTS_VALUE) pts = s->frm->pts;
            uint8_t* dst_data[4] = {s->rgb.data(), nullptr, nullptr, nullptr};
            int dst_linesize[4] = {s->g.new_w * 3, 0, 0, 0};
            sws_scale(s->sws, s->frm->data, s->frm->linesize, 0,
                      s->ctx.dec->height, dst_data, dst_linesize);
            write_canvas_frame(s->rgb.data(), s->g, s->max_width, out);
            av_frame_unref(s->frm);
            if (out_pts) *out_pts = pts;
            return 0;
        }
        if (rr == AVERROR_EOF) return 1;  // the decoder is drained
        if (rr != AVERROR(EAGAIN)) return rr < 0 ? rr : -1;
        if (s->input_eof) return 1;
        int r = av_read_frame(s->ctx.fmt, s->pkt);
        if (r == AVERROR_EOF) {
            s->input_eof = true;
            avcodec_send_packet(s->ctx.dec, nullptr);  // flush
            continue;
        }
        if (r < 0) return r;  // a read error, not the end of the stream
        int sent = 0;
        if (s->pkt->stream_index == s->ctx.stream_idx)
            sent = avcodec_send_packet(s->ctx.dec, s->pkt);
        av_packet_unref(s->pkt);
        if (sent < 0 && sent != AVERROR(EAGAIN)) return sent;
    }
}

void esf_stream_close(void* handle) {
    delete static_cast<StreamCtx*>(handle);
}

// ---------------------------------------------------------------------------
// Streaming mpeg4 encoder: open once, append RGB24 frames per window, close
// writes the trailer. This is the demo's annotated-output sink (constant
// memory over arbitrarily long camera streams — the reference streams through
// cv2.VideoWriter, tools/demo_net.py:62-75); esf_write_test_video composes it
// for one-shot fixture encodes.

struct EncodeCtx {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* enc = nullptr;
    AVStream* st = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frm = nullptr;
    AVPacket* pkt = nullptr;
    int w = 0, h = 0;
    int64_t next_pts = 0;
};

static void encoder_free(EncodeCtx* ctx) {
    if (!ctx) return;
    if (ctx->pkt) av_packet_free(&ctx->pkt);
    if (ctx->frm) av_frame_free(&ctx->frm);
    if (ctx->sws) sws_freeContext(ctx->sws);
    if (ctx->enc) avcodec_free_context(&ctx->enc);
    if (ctx->fmt) {
        if (!(ctx->fmt->oformat->flags & AVFMT_NOFILE) && ctx->fmt->pb)
            avio_closep(&ctx->fmt->pb);
        avformat_free_context(ctx->fmt);
    }
    delete ctx;
}

static int encoder_drain(EncodeCtx* ctx, AVFrame* f) {
    int rc = avcodec_send_frame(ctx->enc, f);
    if (rc < 0 && rc != AVERROR_EOF) return rc;
    while (avcodec_receive_packet(ctx->enc, ctx->pkt) == 0) {
        av_packet_rescale_ts(ctx->pkt, ctx->enc->time_base,
                             ctx->st->time_base);
        // give every packet its display duration (one tick), otherwise the
        // container duration excludes the last frame and avg_frame_rate
        // reads n/(n-1) too high for short clips
        if (ctx->pkt->duration == 0)
            ctx->pkt->duration = av_rescale_q(1, ctx->enc->time_base,
                                              ctx->st->time_base);
        ctx->pkt->stream_index = ctx->st->index;
        rc = av_interleaved_write_frame(ctx->fmt, ctx->pkt);
        av_packet_unref(ctx->pkt);
        if (rc < 0) return rc;  // mux/IO failure (e.g. ENOSPC) propagates
    }
    return 0;
}

// gop: keyframe interval. Fixtures default to 8 (fast seeks in tests);
// pass production-like values (x264 defaults to 250) to exercise
// seek-backoff behavior (e.g. the demo's sequential-vs-seek study).
void* esf_encoder_open2(const char* path, int w, int h, int fps, int gop) {
    EncodeCtx* ctx = new EncodeCtx();
    ctx->w = w;
    ctx->h = h;
    avformat_alloc_output_context2(&ctx->fmt, nullptr, nullptr, path);
    if (!ctx->fmt) { encoder_free(ctx); return nullptr; }
    const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
    if (!codec) { encoder_free(ctx); return nullptr; }
    ctx->st = avformat_new_stream(ctx->fmt, nullptr);
    ctx->enc = avcodec_alloc_context3(codec);
    if (!ctx->st || !ctx->enc) { encoder_free(ctx); return nullptr; }
    ctx->enc->width = w;
    ctx->enc->height = h;
    ctx->enc->time_base = {1, fps};
    ctx->enc->framerate = {fps, 1};
    ctx->enc->pix_fmt = AV_PIX_FMT_YUV420P;
    ctx->enc->gop_size = gop > 0 ? gop : 8;
    ctx->enc->bit_rate = 4000000;
    if (ctx->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        ctx->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(ctx->enc, codec, nullptr) < 0) {
        encoder_free(ctx); return nullptr;
    }
    avcodec_parameters_from_context(ctx->st->codecpar, ctx->enc);
    ctx->st->time_base = ctx->enc->time_base;
    if (!(ctx->fmt->oformat->flags & AVFMT_NOFILE))
        if (avio_open(&ctx->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
            encoder_free(ctx); return nullptr;
        }
    if (avformat_write_header(ctx->fmt, nullptr) < 0) {
        encoder_free(ctx); return nullptr;
    }
    ctx->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h,
                              AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                              nullptr, nullptr, nullptr);
    ctx->frm = av_frame_alloc();
    ctx->frm->format = AV_PIX_FMT_YUV420P;
    ctx->frm->width = w;
    ctx->frm->height = h;
    av_frame_get_buffer(ctx->frm, 0);
    ctx->pkt = av_packet_alloc();
    if (!ctx->sws || !ctx->frm || !ctx->pkt) {
        encoder_free(ctx); return nullptr;
    }
    return ctx;
}

void* esf_encoder_open(const char* path, int w, int h, int fps) {
    return esf_encoder_open2(path, w, h, fps, 8);
}

int esf_encoder_append(void* handle, const unsigned char* rgb, int n) {
    EncodeCtx* ctx = static_cast<EncodeCtx*>(handle);
    if (!ctx) return -1;
    for (int i = 0; i < n; ++i) {
        const uint8_t* src_data[4] = {
            rgb + size_t(i) * ctx->w * ctx->h * 3, nullptr, nullptr, nullptr};
        int src_linesize[4] = {ctx->w * 3, 0, 0, 0};
        av_frame_make_writable(ctx->frm);
        sws_scale(ctx->sws, src_data, src_linesize, 0, ctx->h,
                  ctx->frm->data, ctx->frm->linesize);
        ctx->frm->pts = ctx->next_pts++;
        int rc = encoder_drain(ctx, ctx->frm);
        if (rc < 0) return rc;  // encode/mux failure is NOT silent
    }
    return 0;
}

int esf_encoder_close(void* handle) {
    EncodeCtx* ctx = static_cast<EncodeCtx*>(handle);
    if (!ctx) return -1;
    int rc = encoder_drain(ctx, nullptr);
    int rc2 = av_write_trailer(ctx->fmt);
    encoder_free(ctx);
    return rc < 0 ? rc : rc2;
}

// Encode `n` RGB24 frames (h x w) into an mpeg4 .mp4 — test-fixture helper
// and one-shot form of the streaming encoder above.
int esf_write_test_video(const char* path, const unsigned char* rgb, int n,
                         int w, int h, int fps) {
    void* ctx = esf_encoder_open(path, w, h, fps);
    if (!ctx) return -1;
    int rc = esf_encoder_append(ctx, rgb, n);
    int rc2 = esf_encoder_close(ctx);
    return rc != 0 ? rc : rc2;
}

}  // extern "C"
