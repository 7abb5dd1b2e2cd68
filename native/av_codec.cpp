// Generic compressed-audio decode/encode through FFmpeg's libavformat /
// libavcodec / libswresample — the framework's counterpart of the
// reference CLI's AVFoundation-wide ingest (reference:
// SyllableDetectorCLI/main.swift:63-76, AVAssetReader decodes anything the
// OS knows: AAC/M4A/ALAC/MP3/FLAC/CAF/...).
//
// Exposed as a tiny C ABI so the Python side stays a flat ctypes wrapper
// (struct layouts are the compiler's problem, not ctypes'). Decode returns
// interleaved float32 at the stream's native rate/channel count; encode
// muxes float32 into whatever container the file extension implies, with
// the codec chosen by name or the container default (m4a -> aac).
//
// Build: g++ -O2 -shared -fPIC av_codec.cpp -lavformat -lavcodec
//        -lswresample -lavutil  (FFmpeg >= 5.1, ch_layout API)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

void set_err(char* errbuf, int errlen, const char* fmt, int averr = 0) {
    if (!errbuf || errlen <= 0) return;
    if (averr) {
        char avmsg[256];
        av_strerror(averr, avmsg, sizeof(avmsg));
        snprintf(errbuf, errlen, "%s: %s", fmt, avmsg);
    } else {
        snprintf(errbuf, errlen, "%s", fmt);
    }
}

}  // namespace

extern "C" {

// Decode the first audio stream of `path` to interleaved float32.
// On success (*out) is a malloc'd buffer of (*out_frames * *out_channels)
// floats the caller releases with sdav_free. Returns 0 on success, -1 on
// failure with a message in errbuf.
int sdav_decode_file(const char* path, float** out, int64_t* out_frames,
                     int* out_channels, int* out_rate, char* errbuf,
                     int errlen) {
    *out = nullptr;
    *out_frames = 0;
    *out_channels = 0;
    *out_rate = 0;

    AVFormatContext* fmt = nullptr;
    int rc = avformat_open_input(&fmt, path, nullptr, nullptr);
    if (rc < 0) {
        set_err(errbuf, errlen, "cannot open container", rc);
        return -1;
    }
    AVCodecContext* dec = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    std::vector<float> pcm;
    int ret = -1;

    do {
        rc = avformat_find_stream_info(fmt, nullptr);
        if (rc < 0) {
            set_err(errbuf, errlen, "cannot read stream info", rc);
            break;
        }
        const AVCodec* codec = nullptr;
        int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
        if (si < 0 || !codec) {
            set_err(errbuf, errlen, "no decodable audio stream", si < 0 ? si : 0);
            break;
        }
        AVStream* st = fmt->streams[si];
        dec = avcodec_alloc_context3(codec);
        if (!dec || avcodec_parameters_to_context(dec, st->codecpar) < 0) {
            set_err(errbuf, errlen, "decoder setup failed");
            break;
        }
        rc = avcodec_open2(dec, codec, nullptr);
        if (rc < 0) {
            set_err(errbuf, errlen, "cannot open decoder", rc);
            break;
        }
        const int channels = dec->ch_layout.nb_channels;
        const int rate = dec->sample_rate;
        if (channels < 1 || rate <= 0) {
            set_err(errbuf, errlen, "invalid stream parameters");
            break;
        }
        // resample-context converts ONLY the sample format (to packed
        // float32); rate and channel layout pass through untouched
        AVChannelLayout layout;
        av_channel_layout_copy(&layout, &dec->ch_layout);
        rc = swr_alloc_set_opts2(&swr, &layout, AV_SAMPLE_FMT_FLT, rate,
                                 &layout, dec->sample_fmt, rate, 0, nullptr);
        av_channel_layout_uninit(&layout);
        if (rc < 0 || swr_init(swr) < 0) {
            set_err(errbuf, errlen, "resampler setup failed", rc);
            break;
        }
        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        std::vector<float> tmp;
        bool fail = false;
        auto drain_frames = [&]() -> bool {
            while (true) {
                int r = avcodec_receive_frame(dec, frame);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
                if (r < 0) {
                    set_err(errbuf, errlen, "decode failed", r);
                    return false;
                }
                tmp.resize((size_t)frame->nb_samples * channels);
                uint8_t* dst[1] = {(uint8_t*)tmp.data()};
                int got = swr_convert(swr, dst, frame->nb_samples,
                                      (const uint8_t**)frame->extended_data,
                                      frame->nb_samples);
                if (got < 0) {
                    set_err(errbuf, errlen, "sample conversion failed", got);
                    return false;
                }
                pcm.insert(pcm.end(), tmp.begin(),
                           tmp.begin() + (size_t)got * channels);
                av_frame_unref(frame);
            }
        };
        while ((rc = av_read_frame(fmt, pkt)) >= 0) {
            if (pkt->stream_index == si) {
                if (avcodec_send_packet(dec, pkt) >= 0 && !drain_frames()) {
                    fail = true;
                    av_packet_unref(pkt);
                    break;
                }
            }
            av_packet_unref(pkt);
        }
        if (fail) break;
        avcodec_send_packet(dec, nullptr);  // flush
        if (!drain_frames()) break;

        float* buf = (float*)malloc(pcm.size() * sizeof(float) + 1);
        if (!buf) {
            set_err(errbuf, errlen, "out of memory");
            break;
        }
        memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
        *out = buf;
        *out_frames = (int64_t)(pcm.size() / channels);
        *out_channels = channels;
        *out_rate = rate;
        ret = 0;
    } while (false);

    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return ret;
}

void sdav_free(float* p) { free(p); }

// Encode interleaved float32 `samples` into `path`; the container comes
// from the file extension, the codec from `codec_name` (empty/null ->
// the container's default audio codec, e.g. aac for .m4a). Returns 0 on
// success, -1 on failure with a message in errbuf.
int sdav_encode_file(const char* path, const float* samples, int64_t frames,
                     int channels, int rate, const char* codec_name,
                     char* errbuf, int errlen) {
    AVFormatContext* fmt = nullptr;
    int rc = avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
    if (rc < 0 || !fmt) {
        set_err(errbuf, errlen, "cannot infer container from path", rc);
        return -1;
    }
    AVCodecContext* enc = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    bool header_written = false, io_open = false;
    int ret = -1;

    do {
        const AVCodec* codec =
            (codec_name && codec_name[0])
                ? avcodec_find_encoder_by_name(codec_name)
                : avcodec_find_encoder(fmt->oformat->audio_codec);
        if (!codec) {
            set_err(errbuf, errlen, "no such audio encoder");
            break;
        }
        AVStream* st = avformat_new_stream(fmt, nullptr);
        enc = avcodec_alloc_context3(codec);
        if (!st || !enc) {
            set_err(errbuf, errlen, "encoder setup failed");
            break;
        }
        // pick the encoder's first supported sample format (aac: fltp)
        enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                             : AV_SAMPLE_FMT_FLT;
        enc->sample_rate = rate;
        av_channel_layout_default(&enc->ch_layout, channels);
        enc->bit_rate = 128000 * channels;
        enc->time_base = {1, rate};
        if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
            enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        rc = avcodec_open2(enc, codec, nullptr);
        if (rc < 0) {
            set_err(errbuf, errlen, "cannot open encoder", rc);
            break;
        }
        avcodec_parameters_from_context(st->codecpar, enc);
        st->time_base = enc->time_base;

        rc = swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt, rate,
                                 &enc->ch_layout, AV_SAMPLE_FMT_FLT, rate, 0,
                                 nullptr);
        if (rc < 0 || swr_init(swr) < 0) {
            set_err(errbuf, errlen, "resampler setup failed", rc);
            break;
        }
        if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
            rc = avio_open(&fmt->pb, path, AVIO_FLAG_WRITE);
            if (rc < 0) {
                set_err(errbuf, errlen, "cannot open output file", rc);
                break;
            }
            io_open = true;
        }
        rc = avformat_write_header(fmt, nullptr);
        if (rc < 0) {
            set_err(errbuf, errlen, "cannot write container header", rc);
            break;
        }
        header_written = true;

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        const int chunk = (enc->frame_size > 0) ? enc->frame_size : 1024;
        bool fail = false;
        auto drain_packets = [&](bool flush) -> bool {
            int r = avcodec_send_frame(enc, flush ? nullptr : frame);
            if (r < 0 && r != AVERROR_EOF) {
                set_err(errbuf, errlen, "encode failed", r);
                return false;
            }
            while (true) {
                r = avcodec_receive_packet(enc, pkt);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return true;
                if (r < 0) {
                    set_err(errbuf, errlen, "encode failed", r);
                    return false;
                }
                av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
                pkt->stream_index = st->index;
                r = av_interleaved_write_frame(fmt, pkt);
                if (r < 0) {
                    set_err(errbuf, errlen, "write failed", r);
                    return false;
                }
            }
        };
        int64_t pos = 0;
        while (pos < frames && !fail) {
            const int n = (int)((frames - pos < chunk) ? (frames - pos) : chunk);
            frame->nb_samples = n;
            frame->format = enc->sample_fmt;
            av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
            if (av_frame_get_buffer(frame, 0) < 0) {
                set_err(errbuf, errlen, "frame alloc failed");
                fail = true;
                break;
            }
            const uint8_t* src[1] = {
                (const uint8_t*)(samples + pos * channels)};
            if (swr_convert(swr, frame->extended_data, n, src, n) < 0) {
                set_err(errbuf, errlen, "sample conversion failed");
                fail = true;
                break;
            }
            frame->pts = pos;
            if (!drain_packets(false)) {
                fail = true;
                break;
            }
            av_frame_unref(frame);
            pos += n;
        }
        if (fail) break;
        if (!drain_packets(true)) break;
        ret = 0;
    } while (false);

    if (header_written) av_write_trailer(fmt);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (enc) avcodec_free_context(&enc);
    if (io_open) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
    return ret;
}

}  // extern "C"
