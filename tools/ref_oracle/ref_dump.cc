// Golden-regeneration harness for tests/data/golden/* (VERDICT r2 #7).
//
// Links the UNMODIFIED reference build (libultra_core.a from
// /root/reference, built headlessly) and re-dumps every golden file the
// JAX rebuild's parity tests pin, byte-exact.  One subcommand per golden
// family; tools/ref_oracle/regen.sh drives the full set and diffs.
//
// This file is new test scaffolding that CALLS the reference's public
// API — no reference code is copied.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <random>
#include <string>
#include <vector>

#include "ultra/fec.hpp"
#include "ultra/ofdm.hpp"
#include "ultra/otfs.hpp"
#include "ultra/types.hpp"
#include "../src/gui/adaptive_mode.hpp"
#include "../src/protocol/frame_v2.hpp"
#include "../src/psk/dpsk.hpp"
#include "../src/psk/multi_carrier_dpsk.hpp"

using namespace ultra;
using namespace ultra::protocol::v2;

static std::string hex(const Bytes& b) {
    static const char* d = "0123456789abcdef";
    std::string s;
    for (uint8_t c : b) { s += d[c >> 4]; s += d[c & 15]; }
    return s;
}

static Bytes unhex(const std::string& s) {
    Bytes out;
    for (size_t i = 0; i + 1 < s.size(); i += 2)
        out.push_back((uint8_t)strtol(s.substr(i, 2).c_str(), nullptr, 16));
    return out;
}

static void save_f32(const Samples& a, const std::string& path) {
    std::ofstream f(path, std::ios::binary);
    f.write(reinterpret_cast<const char*>(a.data()),
            a.size() * sizeof(float));
}

static std::string arg(int argc, char** argv, const std::string& key,
                       const std::string& dflt = "") {
    for (int i = 1; i + 1 < argc; i++)
        if (key == argv[i]) return argv[i + 1];
    return dflt;
}

// --------------------------------------------------------------- ldpc
static int dump_ldpc(int argc, char** argv) {
    struct Row { CodeRate r; const char* name; };
    const Row rows[] = {{CodeRate::R1_4, "R1_4"}, {CodeRate::R1_2, "R1_2"},
                        {CodeRate::R2_3, "R2_3"}, {CodeRate::R3_4, "R3_4"},
                        {CodeRate::R5_6, "R5_6"}};
    std::string dir = arg(argc, argv, "--out", ".");
    for (auto& row : rows) {
        Bytes p1 = unhex(arg(argc, argv, std::string("--payload-") + row.name));
        Bytes p2 = unhex(arg(argc, argv, std::string("--payload2-") + row.name));
        LDPCEncoder enc(row.r);
        LDPCDecoder dec(row.r);
        Bytes c1 = enc.encode(p1);
        Bytes c2 = enc.encode(p2);
        Bytes decoded = dec.decode(c1);
        std::ofstream f(dir + "/golden_ldpc_" + row.name + ".txt");
        f << "payload " << hex(p1) << "\n";
        f << "coded " << hex(c1) << "\n";
        f << "payload2 " << hex(p2) << "\n";
        f << "coded2 " << hex(c2) << "\n";
        f << "decoded " << hex(decoded) << "\n";
        f << "success " << (dec.lastDecodeSuccess() ? 1 : 0)
          << " iters " << dec.lastIterations() << "\n";
    }
    return 0;
}

// --------------------------------------------------------- interleavers
static int dump_interleaver(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    Interleaver il(6, 108);
    std::ofstream f(dir + "/golden_interleaver.txt");
    for (size_t i = 0; i < 648; i++)
        f << il.getPermutation(i) << " ";
    f << "\n";
    return 0;
}

static int dump_chinterleaver(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    std::ofstream f(dir + "/golden_chinterleaver.txt");
    for (size_t bps : {60u, 116u, 118u, 30u}) {
        ChannelInterleaver ci(bps, 648);
        f << "bps " << bps << " sep " << ci.getSymbolSeparation()
          << " perm";
        // Recover the permutation by interleaving an index ramp.
        std::vector<float> ramp(648);
        for (size_t i = 0; i < 648; i++) ramp[i] = (float)i;
        auto out = ci.interleave(std::span<const float>(ramp));
        for (float v : out) f << " " << (int)v;
        f << " \n";
    }
    return 0;
}

// --------------------------------------------------------------- frames
static int dump_frames(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    std::ofstream f(dir + "/golden_frames.txt");
    char buf[16];
    snprintf(buf, sizeof buf, "%x", hashCallsign("W1AW"));
    f << "hash_W1AW " << buf << "\n";
    snprintf(buf, sizeof buf, "%x", hashCallsign("ve3abc"));
    f << "hash_VE3ABC " << buf << "\n";
    uint8_t c[5] = {1, 2, 3, 4, 5};
    snprintf(buf, sizeof buf, "%x", ControlFrame::calculateCRC(c, 5));
    f << "crc16 " << buf << "\n";
    f << "ack "
      << hex(ControlFrame::makeAck("W1AW", "VE3ABC", 42).serialize()) << "\n";
    f << "nack "
      << hex(ControlFrame::makeNack("W1AW", "VE3ABC", 7, 0x1D).serialize())
      << "\n";
    f << "modechange "
      << hex(ControlFrame::makeModeChange("W1AW", "VE3ABC", 3,
                                          Modulation::QAM16, CodeRate::R2_3,
                                          21.3f, 0).serialize()) << "\n";
    Bytes payload;
    for (int i = 0; i < 50; i++) payload.push_back((uint8_t)(i * 3 & 0xFF));
    DataFrame df = DataFrame::makeData("W1AW", "VE3ABC", 9, payload);
    f << "dataframe " << hex(df.serialize()) << "\n";
    f << "data_total_cw " << (int)df.total_cw << "\n";
    DataFrame dfr = DataFrame::makeData("W1AW", "VE3ABC", 9, payload,
                                        CodeRate::R1_2);
    f << "data_total_cw_r12 " << (int)dfr.total_cw << "\n";
    f << "connect "
      << hex(ConnectFrame::makeConnect("W1AW", "VE3ABC", 0x3F,
                                       0xFF).serialize()) << "\n";
    f << "connectack "
      << hex(ConnectFrame::makeConnectAck("VE3ABC", "W1AW", 0x05,
                                          Modulation::DQPSK, CodeRate::R1_2,
                                          12.7f).serialize()) << "\n";
    // Codeword split + LDPC-encoded frame (R1/4 default, then R1/2).
    Bytes ser = df.serialize();
    auto cws = splitIntoCodewords(ser);
    f << "ncw " << cws.size() << "\n";
    for (auto& cw : cws) f << "cw " << hex(cw) << "\n";
    auto encs = encodeFrameWithLDPC(ser);
    f << "nenc " << encs.size() << "\n";
    f << "enc0 " << hex(encs.front()) << "\n";
    f << "enclast " << hex(encs.back()) << "\n";
    auto encs2 = encodeFrameWithLDPC(ser, CodeRate::R1_2);
    f << "nenc_r12 " << encs2.size() << "\n";
    f << "enc2_0 " << hex(encs2.front()) << "\n";
    return 0;
}

// ------------------------------------------------------------- adaptive
static int dump_adaptive(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    std::ofstream f(dir + "/golden_adaptive_mode_trace.txt");
    gui::AdaptiveModeController ctl;
    uint32_t s = 12345;
    float snr = 25.0f;
    for (int i = 0; i < 400; i++) {
        s = s * 1664525u + 1013904223u;
        float u = (s >> 8) / 16777216.0f;
        snr = std::min(45.0f, std::max(10.0f, snr + (u - 0.5f) * 6.0f));
        bool sw = ctl.update(snr);
        char line[64];
        snprintf(line, sizeof line, "%.4f %d %d %d\n", snr,
                 (int)ctl.getModulation(), (int)ctl.getCodeRate(),
                 sw ? 1 : 0);
        f << line;
    }
    return 0;
}

// ----------------------------------------------------------------- ofdm
static int dump_ofdm(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    Bytes payload = unhex(arg(argc, argv, "--payload"));

    // OFDM_CHIRP waveform config (ofdm_chirp_waveform.cpp:10-31):
    // 512-FFT, 30 carriers, differential DQPSK, no pilots.
    ModemConfig chirp_cfg;
    chirp_cfg.use_pilots = false;
    chirp_cfg.modulation = Modulation::DQPSK;
    OFDMModulator mod(chirp_cfg);
    Samples tr = mod.generateTrainingSymbols(2);
    Samples data = mod.modulate(payload, Modulation::DQPSK);
    Samples all = tr;
    all.insert(all.end(), data.begin(), data.end());
    save_f32(all, dir + "/golden_ofdm_tx.f32");
    std::ofstream meta(dir + "/golden_ofdm_tx_meta.txt");
    meta << "payload " << hex(payload) << "\n";
    meta << "training " << tr.size() << " data " << data.size() << "\n";

    // Schmidl-Cox preamble + coherent QPSK data, default (pilot) config.
    ModemConfig cox_cfg;
    OFDMModulator mod2(cox_cfg);
    Samples pre = mod2.generatePreamble();
    Samples data2 = mod2.modulate(payload, Modulation::QPSK);
    Samples all2 = pre;
    all2.insert(all2.end(), data2.begin(), data2.end());
    save_f32(all2, dir + "/golden_ofdm_cox_tx.f32");
    return 0;
}

// --------------------------------------------------------------- mcdpsk
static int dump_mcdpsk(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    Bytes payload = unhex(arg(argc, argv, "--payload"));
    MultiCarrierDPSKConfig cfg;  // defaults (8 carriers, 512 sps, DQPSK)
    MultiCarrierDPSKModulator mod(cfg);
    Samples tr = mod.generateTrainingSequence();
    Samples ref = mod.generateReferenceSymbol();
    Samples data = mod.modulate(payload);
    Samples all = tr;
    all.insert(all.end(), ref.begin(), ref.end());
    all.insert(all.end(), data.begin(), data.end());
    save_f32(all, dir + "/golden_mcdpsk_tx.f32");

    MultiCarrierDPSKDemodulator dem(cfg);
    dem.processTraining(SampleSpan(tr.data(), tr.size()));
    float cfo = dem.getEstimatedCFO();
    dem.setReference(SampleSpan(ref.data(), ref.size()));
    auto soft = dem.demodulateSoft(SampleSpan(data.data(), data.size()));

    std::ofstream meta(dir + "/golden_mcdpsk_meta.txt");
    meta << "payload " << hex(payload) << "\n";
    char line[96];
    snprintf(line, sizeof line, "training %zu ref %zu data %zu nsoft %zu "
             "cfo_after_training %.6f\n", tr.size(), ref.size(), data.size(),
             soft.size(), cfo);
    meta << line;
    meta << "soft";
    for (float v : soft) { snprintf(line, sizeof line, " %.5f", v); meta << line; }
    meta << " \n";
    return 0;
}

// ----------------------------------------------------------------- dpsk
static int dump_dpsk(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    Bytes payload = unhex(arg(argc, argv, "--payload"));
    DPSKConfig cfg = dpsk_presets::fast();  // DQPSK @125 baud
    DPSKModulator mod(cfg);
    Samples pre = mod.generatePreamble();
    Samples data = mod.modulate(payload);
    Samples all = pre;
    all.insert(all.end(), data.begin(), data.end());
    save_f32(all, dir + "/golden_dpsk_tx.f32");

    Samples full(2000, 0.0f);
    full.insert(full.end(), all.begin(), all.end());
    full.insert(full.end(), 8000, 0.0f);
    DPSKDemodulator dem(cfg);
    int ds = dem.findPreamble(SampleSpan(full.data(), full.size()));
    float cfo = dem.getEstimatedCFO();
    auto soft = dem.demodulateSoft(SampleSpan(full.data() + ds, data.size()));

    std::ofstream meta(dir + "/golden_dpsk_meta.txt");
    meta << "payload " << hex(payload) << "\n";
    char line[96];
    snprintf(line, sizeof line, "pre %zu dat %zu data_start %d cfo %.4f "
             "nsoft %zu\n", pre.size(), data.size(), ds, cfo, soft.size());
    meta << line;
    meta << "soft";
    for (float v : soft) { snprintf(line, sizeof line, " %.5f", v); meta << line; }
    meta << " \n";
    return 0;
}

// ----------------------------------------------------------------- otfs
static int dump_otfs(int argc, char** argv) {
    std::string dir = arg(argc, argv, "--out", ".");
    Bytes payload = unhex(arg(argc, argv, "--payload"));
    OTFSConfig cfg;  // defaults: M=32, N=16, 512-FFT, CP 64
    OTFSModulator mod(cfg);
    Samples pre = mod.generatePreamble();
    auto dd = mod.mapToDD(payload, Modulation::QPSK);
    Samples frame = mod.modulate(dd, Modulation::QPSK);
    Samples all = pre;
    all.insert(all.end(), frame.begin(), frame.end());
    save_f32(all, dir + "/golden_otfs_tx.f32");
    std::ofstream meta(dir + "/golden_otfs_meta.txt");
    meta << "payload " << hex(payload) << "\n";
    meta << "preamble " << pre.size() << " data " << frame.size() << "\n";
    return 0;
}

int main(int argc, char** argv) {
    if (argc < 2) {
        fprintf(stderr,
                "usage: ref_dump <ldpc|interleaver|chinterleaver|frames|"
                "adaptive|ofdm|mcdpsk|dpsk|otfs> [--out DIR] [--payload* HEX]\n");
        return 2;
    }
    std::string cmd = argv[1];
    if (cmd == "ldpc") return dump_ldpc(argc, argv);
    if (cmd == "interleaver") return dump_interleaver(argc, argv);
    if (cmd == "chinterleaver") return dump_chinterleaver(argc, argv);
    if (cmd == "frames") return dump_frames(argc, argv);
    if (cmd == "adaptive") return dump_adaptive(argc, argv);
    if (cmd == "ofdm") return dump_ofdm(argc, argv);
    if (cmd == "mcdpsk") return dump_mcdpsk(argc, argv);
    if (cmd == "dpsk") return dump_dpsk(argc, argv);
    if (cmd == "otfs") return dump_otfs(argc, argv);
    fprintf(stderr, "unknown subcommand %s\n", cmd.c_str());
    return 2;
}
