/* avref.c — independent H.264 conformance oracle via libavcodec/libx264.
 *
 * The reference's pass/fail oracle is a real third-party decoder:
 * trans_resizer.c:2176-2186 shells to `ffmpeg -v error -f null -`, and
 * experiments/scroll-encoder/scripts/test_encoder.sh:82-91 decodes and
 * extracts frames.  This image has no ffmpeg CLI, but it ships the
 * actual decoder library (libavcodec 59 + libx264 164), so this shim
 * exposes exactly the two capabilities those scripts used:
 *
 *   avref_decode       — Annex-B H.264 -> planar YUV420 frames, with a
 *                        decoder-error count (the `-v error` exit-code
 *                        check, made precise).
 *   avref_encode_x264  — raw YUV420 frames -> baseline/CAVLC Annex-B
 *                        stream from the *real* x264 encoder (the donor
 *                        path of scripts/generate_refs.sh:20-44 and
 *                        netflix_scroll.sh:64-71).
 *
 * Pure C, ctypes-friendly; no state shared across calls except the
 * error counter guarded per call.
 */

#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/log.h>
#include <libavutil/opt.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ---- decoder-error accounting via the av_log hook ---- */

static int g_log_errors;

static void count_errors_cb(void *ptr, int level, const char *fmt,
                            va_list vl) {
    if (level <= AV_LOG_ERROR) {
        g_log_errors++;
        if (getenv("AVREF_VERBOSE"))
            av_log_default_callback(ptr, level, fmt, vl);
    }
}

/* ---- decode ---- */

typedef struct {
    uint8_t *out;
    long cap;
    long used;
    int width, height;
    int nframes;
    int errors;
} DecodeSink;

static int sink_frame(DecodeSink *s, const AVFrame *f) {
    if (f->format != AV_PIX_FMT_YUV420P &&
        f->format != AV_PIX_FMT_YUVJ420P)
        return -2;                       /* outside the Baseline contract */
    if (s->width == 0) {
        s->width = f->width;
        s->height = f->height;
    } else if (f->width != s->width || f->height != s->height) {
        return -3;                       /* mid-stream resolution change */
    }
    long fsz = (long)s->width * s->height * 3 / 2;
    if (s->used + fsz > s->cap)
        return -4;                       /* caller buffer too small */
    uint8_t *dst = s->out + s->used;
    for (int r = 0; r < f->height; r++, dst += f->width)
        memcpy(dst, f->data[0] + (long)r * f->linesize[0], f->width);
    for (int p = 1; p <= 2; p++)
        for (int r = 0; r < f->height / 2; r++, dst += f->width / 2)
            memcpy(dst, f->data[p] + (long)r * f->linesize[p],
                   f->width / 2);
    s->used += fsz;
    s->nframes++;
    return 0;
}

static int drain(AVCodecContext *c, AVFrame *frame, DecodeSink *s) {
    for (;;) {
        int ret = avcodec_receive_frame(c, frame);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF)
            return 0;
        if (ret < 0) {
            s->errors++;
            return 0;
        }
        ret = sink_frame(s, frame);
        if (ret < 0)
            return ret;
    }
}

/* Decode an Annex-B H.264 stream.
 * out        caller buffer for nframes * w*h*3/2 planar YUV420 bytes
 * Returns number of decoded frames (>=0) or a negative error:
 *   -1 alloc/open failure, -2 non-4:2:0 output, -3 resolution change,
 *   -4 out buffer too small.
 * *nerrors = decoder errors (send/receive failures + AV_LOG_ERROR
 * messages) — 0 means the stream decoded clean, the same criterion as
 * `ffmpeg -v error ... -f null -` returning an empty log. */
int avref_decode(const uint8_t *data, long size,
                 uint8_t *out, long out_cap,
                 int *width, int *height, int *nerrors) {
    const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_H264);
    if (!codec)
        return -1;
    AVCodecParserContext *parser = av_parser_init(codec->id);
    AVCodecContext *c = avcodec_alloc_context3(codec);
    AVFrame *frame = av_frame_alloc();
    AVPacket *pkt = av_packet_alloc();
    uint8_t *buf = av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE);
    DecodeSink sink = {out, out_cap, 0, 0, 0, 0, 0};
    int rc = -1;

    if (!parser || !c || !frame || !pkt || !buf)
        goto done;
    memcpy(buf, data, size);
    memset(buf + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    if (avcodec_open2(c, codec, NULL) < 0)
        goto done;

    g_log_errors = 0;
    av_log_set_level(AV_LOG_ERROR);
    av_log_set_callback(count_errors_cb);

    rc = 0;
    const uint8_t *p = buf;
    long remaining = size;
    while (!rc) {
        /* A zero-size call (after the data is consumed) signals EOF to
         * the parser, which then returns its buffered access units; the
         * loop ends when an EOF-signaling call yields no packet. */
        int at_eof = remaining <= 0;
        int used = av_parser_parse2(parser, c, &pkt->data, &pkt->size,
                                    p, (int)remaining,
                                    AV_NOPTS_VALUE, AV_NOPTS_VALUE, 0);
        if (used < 0) {
            sink.errors++;
            break;
        }
        p += used;
        remaining -= used;
        if (pkt->size) {
            if (avcodec_send_packet(c, pkt) < 0)
                sink.errors++;
            rc = drain(c, frame, &sink);
        } else if (at_eof) {
            break;                        /* parser fully flushed */
        }
    }
    if (!rc) {                            /* flush the decoder */
        avcodec_send_packet(c, NULL);
        rc = drain(c, frame, &sink);
    }

    av_log_set_callback(av_log_default_callback);
    if (!rc) {
        *width = sink.width;
        *height = sink.height;
        *nerrors = sink.errors + g_log_errors;
        rc = sink.nframes;
    }

done:
    av_free(buf);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&c);
    av_parser_close(parser);
    return rc;
}

/* ---- encode (real x264 donor streams) ---- */

/* Encode nframes of planar YUV420 with libx264 at constant QP.
 * Pinned to the reference donor contract: baseline profile (=> CAVLC,
 * no B-frames), keyint/min-keyint = `keyint` (1 => all-IDR donors as in
 * generate_refs.sh), `refs` reference frames, scenecut off.
 * extra_params: extra colon-separated x264-params ("" for none).
 * Returns bytes written to out (>0) or negative error. */
long avref_encode_x264(const uint8_t *yuv, int width, int height,
                       int nframes, int qp, int keyint, int refs,
                       const char *extra_params,
                       uint8_t *out, long out_cap) {
    const AVCodec *codec = avcodec_find_encoder_by_name("libx264");
    if (!codec)
        return -1;
    AVCodecContext *c = avcodec_alloc_context3(codec);
    AVFrame *frame = av_frame_alloc();
    AVPacket *pkt = av_packet_alloc();
    long used = 0;
    long rc = -1;

    if (!c || !frame || !pkt)
        goto done;
    av_log_set_level(AV_LOG_ERROR);       /* silence x264 info banners */
    c->width = width;
    c->height = height;
    c->pix_fmt = AV_PIX_FMT_YUV420P;
    c->time_base = (AVRational){1, 25};
    c->gop_size = keyint;
    c->max_b_frames = 0;
    c->refs = refs;
    av_opt_set(c->priv_data, "profile", "baseline", 0);
    char params[512];
    snprintf(params, sizeof params,
             "qp=%d:keyint=%d:min-keyint=%d:ref=%d:bframes=0:scenecut=0"
             "%s%s",
             qp, keyint, keyint, refs,
             (extra_params && extra_params[0]) ? ":" : "",
             extra_params ? extra_params : "");
    av_opt_set(c->priv_data, "x264-params", params, 0);
    if (avcodec_open2(c, codec, NULL) < 0)
        goto done;

    long fsz = (long)width * height * 3 / 2;
    for (int i = 0; i <= nframes; i++) {
        AVFrame *f = NULL;
        if (i < nframes) {
            frame->format = c->pix_fmt;
            frame->width = width;
            frame->height = height;
            if (av_frame_get_buffer(frame, 0) < 0)
                goto done;
            const uint8_t *src = yuv + i * fsz;
            for (int r = 0; r < height; r++, src += width)
                memcpy(frame->data[0] + (long)r * frame->linesize[0],
                       src, width);
            for (int p = 1; p <= 2; p++)
                for (int r = 0; r < height / 2; r++, src += width / 2)
                    memcpy(frame->data[p] + (long)r * frame->linesize[p],
                           src, width / 2);
            frame->pts = i;
            f = frame;
        }
        if (avcodec_send_frame(c, f) < 0)
            goto done;
        for (;;) {
            int ret = avcodec_receive_packet(c, pkt);
            if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF)
                break;
            if (ret < 0)
                goto done;
            if (used + pkt->size > out_cap) {
                av_packet_unref(pkt);
                rc = -4;
                goto done;
            }
            memcpy(out + used, pkt->data, pkt->size);
            used += pkt->size;
            av_packet_unref(pkt);
        }
        if (f)
            av_frame_unref(frame);
    }
    rc = used;

done:
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&c);
    return rc;
}

unsigned avref_version(void) {
    return avcodec_version();
}
