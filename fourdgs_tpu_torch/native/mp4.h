// The ISO-BMFF (MP4) demuxer of the port's video decoders (h264.cpp,
// mpeg4.cpp), and the failures they report through their C APIs.
//
// demux_mp4 reads an MP4 file's first video track: ftyp, moov/trak/mdia
// (hdlr 'vide')/minf/stbl, stsd's first sample entry (its type; for 'mp4v'
// the esds box's objectTypeIndication and DecoderSpecificInfo, for 'avc1'
// and 'avc3' the avcC box), stsc, stsz or stz2, stco or co64, mdat
// anywhere, and the samples in decoding order. An edit list that drops
// samples (a positive media_time) is refused, as cv2 would not return the
// dropped frames.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace native {

struct Failure {
  int kind;  // 1 corrupt, 2 not supported
  std::string msg;
};

[[noreturn]] inline void corrupt(const std::string& m) { throw Failure{1, m}; }
[[noreturn]] inline void refuse(const std::string& m) { throw Failure{2, m}; }

// a failure as the C APIs return it: -1 corrupt, -2 not supported, the
// message copied into err
inline int report(const Failure& f, char* err, int err_len) {
  if (err && err_len > 0) {
    std::string m = f.msg.substr(0, size_t(err_len - 1));
    memcpy(err, m.c_str(), m.size() + 1);
  }
  return f.kind == 2 ? -2 : -1;
}

inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}
inline uint64_t be64(const uint8_t* p) { return uint64_t(be32(p)) << 32 | be32(p + 4); }

struct Box {
  uint32_t type;
  size_t body, end;  // payload start and end offsets
};

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 |
         uint32_t(uint8_t(s[2])) << 8 | uint8_t(s[3]);
}

inline std::string fourcc_name(uint32_t t) {
  char name[5] = {char(t >> 24), char(t >> 16), char(t >> 8), char(t), 0};
  return name;
}

inline std::vector<Box> boxes(const uint8_t* d, size_t start, size_t end) {
  std::vector<Box> out;
  size_t pos = start;
  while (pos + 8 <= end) {
    uint64_t size = be32(d + pos);
    uint32_t type = be32(d + pos + 4);
    size_t hdr = 8;
    if (size == 1) {
      if (pos + 16 > end) corrupt("truncated MP4 box header");
      size = be64(d + pos + 8);
      hdr = 16;
    } else if (size == 0) {
      size = end - pos;
    }
    if (size < hdr || pos + size > end) corrupt("MP4 box overruns its parent");
    out.push_back({type, pos + hdr, size_t(pos + size)});
    pos += size_t(size);
  }
  return out;
}

inline const Box* find(const std::vector<Box>& bs, const char* t) {
  for (auto& b : bs)
    if (b.type == fourcc(t)) return &b;
  return nullptr;
}

inline bool is_mp4(const uint8_t* d, size_t n) {
  if (n < 8) return false;
  uint32_t t = be32(d + 4);
  return t == fourcc("ftyp") || t == fourcc("moov") || t == fourcc("mdat") || t == fourcc("free") ||
         t == fourcc("wide") || t == fourcc("skip");
}

using Span = std::pair<const uint8_t*, size_t>;

// an MP4 file's first video track
struct Track {
  uint32_t entry = 0;  // the sample entry's type ('avc1', 'mp4v', ...)
  int oti = -1;        // 'mp4v': the esds objectTypeIndication (-1 without an esds)
  // 'avc1' / 'avc3': the avcC box's payload; 'mp4v': the DecoderSpecificInfo
  Span config{nullptr, 0};
  std::vector<Span> samples;  // in decoding order
};

// an MPEG-4 Systems descriptor's tag and payload [body, end) at d[p]
inline bool descriptor(const uint8_t* d, size_t p, size_t end, int* tag, size_t* body,
                       size_t* dend) {
  if (p >= end) return false;
  *tag = d[p++];
  size_t len = 0;
  for (int i = 0; i < 4; i++) {
    if (p >= end) corrupt("truncated esds descriptor");
    uint8_t c = d[p++];
    len = len << 7 | (c & 0x7F);
    if (!(c & 0x80)) break;
  }
  if (p + len > end) corrupt("esds descriptor overruns its box");
  *body = p;
  *dend = p + len;
  return true;
}

// the esds box's DecoderConfigDescriptor: objectTypeIndication and
// DecoderSpecificInfo
inline void parse_esds(const uint8_t* d, const Box& esds, Track& t) {
  if (esds.end - esds.body < 4) corrupt("truncated esds");
  int tag;
  size_t body, end;
  if (!descriptor(d, esds.body + 4, esds.end, &tag, &body, &end) || tag != 3)
    corrupt("esds without an ES_Descriptor");
  if (end - body < 3) corrupt("truncated ES_Descriptor");
  uint8_t flags = d[body + 2];
  size_t p = body + 3;
  if (flags & 0x80) p += 2;                    // dependsOn_ES_ID
  if (flags & 0x40) {                          // URL
    if (p >= end) corrupt("truncated ES_Descriptor");
    p += 1 + d[p];
  }
  if (flags & 0x20) p += 2;                    // OCR_ES_Id
  size_t dc_body, dc_end;
  while (descriptor(d, p, end, &tag, &dc_body, &dc_end)) {
    p = dc_end;
    if (tag != 4) continue;
    if (dc_end - dc_body < 13) corrupt("truncated DecoderConfigDescriptor");
    t.oti = d[dc_body];
    size_t q = dc_body + 13, s_body, s_end;
    while (descriptor(d, q, dc_end, &tag, &s_body, &s_end)) {
      q = s_end;
      if (tag == 5) t.config = {d + s_body, s_end - s_body};
    }
    return;
  }
  corrupt("esds without a DecoderConfigDescriptor");
}

inline Track demux_mp4(const uint8_t* d, size_t n) {
  auto top = boxes(d, 0, n);
  const Box* moov = find(top, "moov");
  if (!moov) corrupt("MP4 file without a moov box");
  for (auto& trak : boxes(d, moov->body, moov->end)) {
    if (trak.type != fourcc("trak")) continue;
    auto tk = boxes(d, trak.body, trak.end);
    const Box* mdia = find(tk, "mdia");
    if (!mdia) continue;
    auto md = boxes(d, mdia->body, mdia->end);
    const Box* hdlr = find(md, "hdlr");
    if (!hdlr || hdlr->end - hdlr->body < 12 || be32(d + hdlr->body + 8) != fourcc("vide"))
      continue;
    const Box* minf = find(md, "minf");
    if (!minf) corrupt("video track without minf");
    auto mi = boxes(d, minf->body, minf->end);
    const Box* stbl = find(mi, "stbl");
    if (!stbl) corrupt("video track without stbl");
    auto st = boxes(d, stbl->body, stbl->end);
    const Box* stsd = find(st, "stsd");
    if (!stsd || stsd->end - stsd->body < 8) corrupt("video track without stsd");
    auto entries = boxes(d, stsd->body + 8, stsd->end);
    if (entries.empty()) corrupt("empty stsd");
    const Box& e = entries[0];
    Track t;
    t.entry = e.type;
    // a VisualSampleEntry's fixed fields take 78 bytes before its boxes
    if (e.type == fourcc("avc1") || e.type == fourcc("avc3")) {
      if (e.end - e.body < 78) corrupt("truncated avc1 sample entry");
      auto inner = boxes(d, e.body + 78, e.end);
      const Box* avcc = find(inner, "avcC");
      if (!avcc) corrupt("avc1 sample entry without avcC");
      t.config = {d + avcc->body, avcc->end - avcc->body};
    } else if (e.type == fourcc("mp4v")) {
      if (e.end - e.body < 78) corrupt("truncated mp4v sample entry");
      auto inner = boxes(d, e.body + 78, e.end);
      if (const Box* esds = find(inner, "esds")) parse_esds(d, *esds, t);
    }
    if (const Box* edts = find(tk, "edts")) {
      auto ed = boxes(d, edts->body, edts->end);
      if (const Box* elst = find(ed, "elst")) {
        const uint8_t* a = d + elst->body;
        size_t an = elst->end - elst->body;
        if (an < 8) corrupt("truncated elst");
        int version = a[0];
        uint32_t cnt = be32(a + 4);
        size_t esz = version == 1 ? 20 : 12;
        if (8 + esz * cnt > an) corrupt("truncated elst");
        for (uint32_t i = 0; i < cnt; i++) {
          const uint8_t* q = a + 8 + esz * i;
          int64_t media_time = version == 1 ? int64_t(be64(q + 8)) : int32_t(be32(q + 4));
          if (media_time > 0) refuse("an edit list that drops samples");
        }
      }
    }
    // sample sizes
    std::vector<uint32_t> sizes;
    if (const Box* stsz = find(st, "stsz")) {
      const uint8_t* a = d + stsz->body;
      if (stsz->end - stsz->body < 12) corrupt("truncated stsz");
      uint32_t fixed = be32(a + 4), cnt = be32(a + 8);
      if (!fixed && 12 + size_t(cnt) * 4 > stsz->end - stsz->body) corrupt("truncated stsz");
      for (uint32_t i = 0; i < cnt; i++) sizes.push_back(fixed ? fixed : be32(a + 12 + 4 * i));
    } else if (const Box* stz2 = find(st, "stz2")) {
      const uint8_t* a = d + stz2->body;
      if (stz2->end - stz2->body < 12) corrupt("truncated stz2");
      int field = a[7];
      uint32_t cnt = be32(a + 8);
      if (field != 4 && field != 8 && field != 16) corrupt("stz2 field size out of range");
      if (12 + (size_t(cnt) * field + 7) / 8 > stz2->end - stz2->body) corrupt("truncated stz2");
      for (uint32_t i = 0; i < cnt; i++) {
        uint32_t v;
        if (field == 16) v = uint32_t(a[12 + 2 * i]) << 8 | a[13 + 2 * i];
        else if (field == 8) v = a[12 + i];
        else v = (a[12 + i / 2] >> (i % 2 ? 0 : 4)) & 15;
        sizes.push_back(v);
      }
    } else {
      corrupt("video track without stsz or stz2");
    }
    std::vector<uint64_t> chunks;
    if (const Box* stco = find(st, "stco")) {
      const uint8_t* a = d + stco->body;
      uint32_t cnt = be32(a + 4);
      if (8 + size_t(cnt) * 4 > stco->end - stco->body) corrupt("truncated stco");
      for (uint32_t i = 0; i < cnt; i++) chunks.push_back(be32(a + 8 + 4 * i));
    } else if (const Box* co64 = find(st, "co64")) {
      const uint8_t* a = d + co64->body;
      uint32_t cnt = be32(a + 4);
      if (8 + size_t(cnt) * 8 > co64->end - co64->body) corrupt("truncated co64");
      for (uint32_t i = 0; i < cnt; i++) chunks.push_back(be64(a + 8 + 8 * i));
    } else {
      corrupt("video track without stco or co64");
    }
    const Box* stsc = find(st, "stsc");
    if (!stsc) corrupt("video track without stsc");
    const uint8_t* a = d + stsc->body;
    uint32_t runs = be32(a + 4);
    if (8 + size_t(runs) * 12 > stsc->end - stsc->body) corrupt("truncated stsc");
    size_t sample = 0;
    for (uint32_t r = 0; r < runs; r++) {
      uint32_t first = be32(a + 8 + 12 * r), per = be32(a + 12 + 12 * r);
      uint32_t last = r + 1 < runs ? be32(a + 8 + 12 * (r + 1)) : uint32_t(chunks.size()) + 1;
      if (first < 1 || last < first || last > chunks.size() + 1) corrupt("stsc out of range");
      for (uint32_t c = first; c < last; c++) {
        uint64_t off = chunks[c - 1];
        for (uint32_t s = 0; s < per && sample < sizes.size(); s++, sample++) {
          uint64_t end = off + sizes[sample];
          if (end > n) corrupt("sample outside the file");
          t.samples.emplace_back(d + off, size_t(sizes[sample]));
          off = end;
        }
      }
    }
    return t;
  }
  corrupt("MP4 file without a video track");
}

}  // namespace native
