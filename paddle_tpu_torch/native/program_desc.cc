// Native Program IR library: parse / validate / prune / stats / text dump
// over the serialized ProgramDef wire format (framework/framework.proto).
//
// The port of paddle_tpu/native/program_desc.cc with the same C ABI
// (pt_desc_validate, pt_desc_prune, pt_desc_stats, pt_desc_text,
// pt_desc_free).  That library is built from protoc's generated classes
// and links libprotobuf; the card's machine has neither, so this file
// holds its own proto2 codec for the six messages of framework.proto,
// table-driven like framework/proto_io.py, and reproduces what the
// generated classes do:
//   * parsing: a field whose wire type does not match its declaration,
//     an unknown field number, and an enum value outside its enum are
//     kept as unknown fields; repeated scalars accept packed and unpacked
//     encodings; a missing required field, field number 0, a stray
//     end-group tag, wire types 6 and 7, or truncated bytes fail;
//   * serializing: the set fields in field-number order (int_list,
//     float_list and shape packed), then the unknown fields as parsed;
//   * the text dump is DebugString: two-space nesting, doubles as
//     SimpleDtoa prints them (%.15g, %.17g where that does not read
//     back), strings as CEscape escapes them, enums by name, unknown
//     fields last by number.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 program_desc.cc (no protobuf).

#include <cfloat>
#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Schema (framework.proto's numbers and types)

enum Type { STRING, BOOL, INT32, INT64, DOUBLE, ENUM, MESSAGE };
enum Label { OPT, REQ, REP, PACKED };

struct MsgDef;

struct FieldDef {
  int number;
  const char* name;
  Type type;
  Label label;
  const MsgDef* sub;          // MESSAGE
  const char* const* names;   // ENUM: value names
  int n_names;
};

struct MsgDef {
  const FieldDef* fields;  // by field number order
  int n_fields;
  int max_number;
};

const char* const kAttrKinds[] = {"BOOL",        "INT",        "FLOAT",
                                  "STRING",      "INT_LIST",   "FLOAT_LIST",
                                  "STRING_LIST", "BOOL_LIST",  "BLOCK",
                                  "JSON"};
const char* const kVarKinds[] = {"LOD_TENSOR",   "SELECTED_ROWS",
                                 "FEED_MINIBATCH", "FETCH_LIST",
                                 "STEP_SCOPES",  "RANK_TABLE",
                                 "TENSOR_ARRAY", "RAW"};
constexpr int kBlockKind = 8;  // AttrValue.Kind.BLOCK

extern const MsgDef kAttrValue, kSlot, kOpDef, kVarDef, kBlockDef,
    kProgramDef;

const FieldDef kAttrValueFields[] = {
    {1, "name", STRING, REQ, nullptr, nullptr, 0},
    {2, "kind", ENUM, REQ, nullptr, kAttrKinds, 10},
    {3, "b", BOOL, OPT, nullptr, nullptr, 0},
    {4, "i", INT64, OPT, nullptr, nullptr, 0},
    {5, "f", DOUBLE, OPT, nullptr, nullptr, 0},
    {6, "s", STRING, OPT, nullptr, nullptr, 0},
    {7, "int_list", INT64, PACKED, nullptr, nullptr, 0},
    {8, "float_list", DOUBLE, PACKED, nullptr, nullptr, 0},
    {9, "string_list", STRING, REP, nullptr, nullptr, 0},
    {10, "bool_list", BOOL, REP, nullptr, nullptr, 0},
    {11, "block_idx", INT32, OPT, nullptr, nullptr, 0},
    {12, "value_json", STRING, OPT, nullptr, nullptr, 0},
};
const FieldDef kSlotFields[] = {
    {1, "name", STRING, REQ, nullptr, nullptr, 0},
    {2, "arguments", STRING, REP, nullptr, nullptr, 0},
};
const FieldDef kOpDefFields[] = {
    {1, "type", STRING, REQ, nullptr, nullptr, 0},
    {2, "inputs", MESSAGE, REP, &kSlot, nullptr, 0},
    {3, "outputs", MESSAGE, REP, &kSlot, nullptr, 0},
    {4, "attrs", MESSAGE, REP, &kAttrValue, nullptr, 0},
};
const FieldDef kVarDefFields[] = {
    {1, "name", STRING, REQ, nullptr, nullptr, 0},
    {2, "kind", ENUM, OPT, nullptr, kVarKinds, 8},
    {3, "dtype", STRING, OPT, nullptr, nullptr, 0},
    {4, "shape", INT64, PACKED, nullptr, nullptr, 0},
    {5, "persistable", BOOL, OPT, nullptr, nullptr, 0},
    {6, "stop_gradient", BOOL, OPT, nullptr, nullptr, 0},
    {7, "is_parameter", BOOL, OPT, nullptr, nullptr, 0},
    {8, "trainable", BOOL, OPT, nullptr, nullptr, 0},
    {9, "partition_spec", STRING, OPT, nullptr, nullptr, 0},
    {10, "lod_level", INT32, OPT, nullptr, nullptr, 0},
    {11, "is_data", BOOL, OPT, nullptr, nullptr, 0},
    {12, "accumulator_for", STRING, OPT, nullptr, nullptr, 0},
};
const FieldDef kBlockDefFields[] = {
    {1, "idx", INT32, REQ, nullptr, nullptr, 0},
    {2, "parent_idx", INT32, REQ, nullptr, nullptr, 0},
    {3, "vars", MESSAGE, REP, &kVarDef, nullptr, 0},
    {4, "ops", MESSAGE, REP, &kOpDef, nullptr, 0},
};
const FieldDef kProgramDefFields[] = {
    {1, "blocks", MESSAGE, REP, &kBlockDef, nullptr, 0},
    {2, "version", INT64, OPT, nullptr, nullptr, 0},
    {3, "random_seed", INT64, OPT, nullptr, nullptr, 0},
};

const MsgDef kAttrValue = {kAttrValueFields, 12, 12};
const MsgDef kSlot = {kSlotFields, 2, 2};
const MsgDef kOpDef = {kOpDefFields, 4, 4};
const MsgDef kVarDef = {kVarDefFields, 12, 12};
const MsgDef kBlockDef = {kBlockDefFields, 4, 4};
const MsgDef kProgramDef = {kProgramDefFields, 3, 3};

// ---------------------------------------------------------------------------
// Messages

// A field the schema does not know (or a known number on another wire
// type, or an enum value outside the enum), as protobuf's UnknownField.
struct Unknown {
  int number;
  int wire;  // 0 varint, 1 fixed64, 2 bytes, 3 group, 5 fixed32
  uint64_t v = 0;
  std::string bytes;
  std::vector<Unknown> group;
};

struct Msg;

// One field's values: `ints` for bool/int32/int64/enum, `dbls`, `strs`,
// `msgs`; a singular field holds at most one, `has` its presence.
struct Field {
  bool has = false;
  std::vector<int64_t> ints;
  std::vector<double> dbls;
  std::vector<std::string> strs;
  std::vector<Msg> msgs;
};

struct Msg {
  const MsgDef* def = nullptr;
  std::vector<Field> f;  // indexed by field number
  std::vector<Unknown> unknown;

  Msg() = default;
  explicit Msg(const MsgDef* d) : def(d), f(d->max_number + 1) {}
  Field& at(int number) { return f[number]; }
  const Field& at(int number) const { return f[number]; }
  int64_t get_int(int number, int64_t dflt = 0) const {
    const Field& x = f[number];
    return x.has && !x.ints.empty() ? x.ints.back() : dflt;
  }
  void set_int(int number, int64_t v) {
    Field& x = f[number];
    x.has = true;
    x.ints.assign(1, v);
  }
  const std::string& get_str(int number) const {
    static const std::string empty;
    const Field& x = f[number];
    return x.has && !x.strs.empty() ? x.strs.back() : empty;
  }
  std::vector<Msg>& msgs(int number) { return f[number].msgs; }
  const std::vector<Msg>& msgs(int number) const { return f[number].msgs; }
};

// Field numbers used below.
enum {
  P_BLOCKS = 1, P_VERSION = 2, P_SEED = 3,
  B_IDX = 1, B_PARENT = 2, B_VARS = 3, B_OPS = 4,
  V_NAME = 1, V_PERSISTABLE = 5, V_IS_PARAMETER = 7, V_IS_DATA = 11,
  O_TYPE = 1, O_INPUTS = 2, O_OUTPUTS = 3, O_ATTRS = 4,
  S_ARGS = 2,
  A_KIND = 2, A_BLOCK_IDX = 11,
};

// ---------------------------------------------------------------------------
// Wire decoding

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool done() const { return p >= end; }
  uint64_t varint() {
    uint64_t n = 0;
    for (int shift = 0; shift < 70; shift += 7) {
      if (p >= end) {
        ok = false;
        return 0;
      }
      uint8_t b = *p++;
      if (shift < 64) n |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return n;
    }
    ok = false;  // longer than ten bytes
    return 0;
  }
  uint64_t fixed(int size) {
    if (end - p < size) {
      ok = false;
      return 0;
    }
    uint64_t n = 0;
    for (int i = 0; i < size; ++i) n |= static_cast<uint64_t>(p[i]) << (8 * i);
    p += size;
    return n;
  }
  std::string bytes(uint64_t size) {
    if (static_cast<uint64_t>(end - p) < size) {
      ok = false;
      return std::string();
    }
    std::string s(reinterpret_cast<const char*>(p), size);
    p += size;
    return s;
  }
};

// One unknown field's value after its tag; groups read to their end tag.
bool read_unknown(Reader* r, int number, int wire, Unknown* u, int depth) {
  u->number = number;
  u->wire = wire;
  switch (wire) {
    case 0:
      u->v = r->varint();
      return r->ok;
    case 1:
      u->v = r->fixed(8);
      return r->ok;
    case 5:
      u->v = r->fixed(4);
      return r->ok;
    case 2:
      u->bytes = r->bytes(r->varint());
      return r->ok;
    case 3: {
      if (depth > 100) return false;
      while (true) {
        uint64_t key = r->varint();
        if (!r->ok) return false;
        int n = static_cast<int>(key >> 3), w = static_cast<int>(key & 7);
        if (w == 4) return n == number;
        if (n == 0) return false;
        Unknown sub;
        if (!read_unknown(r, n, w, &sub, depth + 1)) return false;
        u->group.push_back(std::move(sub));
      }
    }
    default:
      return false;
  }
}

int32_t as_int32(uint64_t n) { return static_cast<int32_t>(static_cast<uint32_t>(n)); }

double as_double(uint64_t bits) {
  double d;
  std::memcpy(&d, &bits, sizeof d);
  return d;
}

bool parse(const MsgDef* def, const uint8_t* buf, size_t len, Msg* out,
           int depth);

// One scalar of a known field from a varint or fixed64 payload.
void store_scalar(const FieldDef& fd, uint64_t v, Msg* m) {
  Field& x = m->at(fd.number);
  bool rep = fd.label == REP || fd.label == PACKED;
  if (fd.type == DOUBLE) {
    if (!rep) x.dbls.clear();
    x.dbls.push_back(as_double(v));
  } else {
    int64_t i = fd.type == BOOL ? (v != 0)
                : fd.type == INT64 ? static_cast<int64_t>(v)
                                   : as_int32(v);
    if (!rep) x.ints.clear();
    x.ints.push_back(i);
  }
  x.has = true;
}

bool enum_valid(const FieldDef& fd, uint64_t v) {
  int32_t i = as_int32(v);
  return i >= 0 && i < fd.n_names;
}

bool parse(const MsgDef* def, const uint8_t* buf, size_t len, Msg* out,
           int depth) {
  if (depth > 100) return false;
  *out = Msg(def);
  Reader r{buf, buf + len};
  while (!r.done()) {
    uint64_t key = r.varint();
    if (!r.ok) return false;
    int number = key >> 3 > 0x1FFFFFFF ? -1 : static_cast<int>(key >> 3);
    int wire = static_cast<int>(key & 7);
    if (number <= 0 || wire == 4 || wire > 5) return false;
    const FieldDef* fd = nullptr;
    for (int i = 0; i < def->n_fields; ++i)
      if (def->fields[i].number == number) fd = &def->fields[i];
    bool rep_scalar = fd && fd->type != STRING && fd->type != MESSAGE &&
                      (fd->label == REP || fd->label == PACKED);
    int want = !fd ? -1
               : fd->type == STRING || fd->type == MESSAGE ? 2
               : fd->type == DOUBLE                        ? 1
                                                           : 0;
    if (fd && wire == want) {
      if (fd->type == MESSAGE) {
        std::string data = r.bytes(r.varint());
        if (!r.ok) return false;
        Msg sub;
        if (!parse(fd->sub, reinterpret_cast<const uint8_t*>(data.data()),
                   data.size(), &sub, depth + 1))
          return false;
        out->at(number).msgs.push_back(std::move(sub));
        out->at(number).has = true;
      } else if (fd->type == STRING) {
        std::string s = r.bytes(r.varint());
        if (!r.ok) return false;
        Field& x = out->at(number);
        if (fd->label == OPT || fd->label == REQ) x.strs.clear();
        x.strs.push_back(std::move(s));
        x.has = true;
      } else {
        uint64_t v = wire == 1 ? r.fixed(8) : r.varint();
        if (!r.ok) return false;
        if (fd->type == ENUM && !enum_valid(*fd, v)) {
          Unknown u;
          u.number = number;
          u.wire = 0;
          u.v = v;
          out->unknown.push_back(std::move(u));
        } else {
          store_scalar(*fd, v, out);
        }
      }
      continue;
    }
    if (rep_scalar && wire == 2) {  // a packed run
      std::string data = r.bytes(r.varint());
      if (!r.ok) return false;
      Reader pr{reinterpret_cast<const uint8_t*>(data.data()),
                reinterpret_cast<const uint8_t*>(data.data()) + data.size()};
      Field& x = out->at(number);
      x.has = true;
      while (!pr.done()) {
        uint64_t v = want == 1 ? pr.fixed(8) : pr.varint();
        if (!pr.ok) return false;
        store_scalar(*fd, v, out);
      }
      continue;
    }
    Unknown u;
    if (!read_unknown(&r, number, wire, &u, depth)) return false;
    out->unknown.push_back(std::move(u));
  }
  // required fields, as IsInitialized
  for (int i = 0; i < def->n_fields; ++i) {
    const FieldDef& fd = def->fields[i];
    if (fd.label == REQ && !out->at(fd.number).has) return false;
  }
  return true;
}

bool parse_program(const uint8_t* buf, uint64_t len, Msg* prog) {
  if (len > static_cast<uint64_t>(INT32_MAX)) return false;
  return parse(&kProgramDef, buf, static_cast<size_t>(len), prog, 0);
}

// ---------------------------------------------------------------------------
// Wire encoding

void put_varint(std::string* out, uint64_t n) {
  while (n >= 0x80) {
    out->push_back(static_cast<char>((n & 0x7F) | 0x80));
    n >>= 7;
  }
  out->push_back(static_cast<char>(n));
}

void put_fixed(std::string* out, uint64_t n, int size) {
  for (int i = 0; i < size; ++i) out->push_back(static_cast<char>(n >> (8 * i)));
}

void put_key(std::string* out, int number, int wire) {
  put_varint(out, (static_cast<uint64_t>(number) << 3) | wire);
}

uint64_t double_bits(double d) {
  uint64_t bits;
  std::memcpy(&bits, &d, sizeof bits);
  return bits;
}

void put_unknown(std::string* out, const Unknown& u) {
  put_key(out, u.number, u.wire);
  switch (u.wire) {
    case 0: put_varint(out, u.v); break;
    case 1: put_fixed(out, u.v, 8); break;
    case 5: put_fixed(out, u.v, 4); break;
    case 2:
      put_varint(out, u.bytes.size());
      out->append(u.bytes);
      break;
    case 3:
      for (const Unknown& g : u.group) put_unknown(out, g);
      put_key(out, u.number, 4);
      break;
  }
}

void serialize(const Msg& m, std::string* out) {
  const MsgDef* def = m.def;
  for (int i = 0; i < def->n_fields; ++i) {
    const FieldDef& fd = def->fields[i];
    const Field& x = m.at(fd.number);
    if (!x.has) continue;
    switch (fd.type) {
      case MESSAGE:
        for (const Msg& sub : x.msgs) {
          std::string data;
          serialize(sub, &data);
          put_key(out, fd.number, 2);
          put_varint(out, data.size());
          out->append(data);
        }
        break;
      case STRING:
        for (const std::string& s : x.strs) {
          put_key(out, fd.number, 2);
          put_varint(out, s.size());
          out->append(s);
        }
        break;
      case DOUBLE:
        if (fd.label == PACKED) {
          if (x.dbls.empty()) break;
          put_key(out, fd.number, 2);
          put_varint(out, 8 * x.dbls.size());
          for (double d : x.dbls) put_fixed(out, double_bits(d), 8);
        } else {
          for (double d : x.dbls) {
            put_key(out, fd.number, 1);
            put_fixed(out, double_bits(d), 8);
          }
        }
        break;
      default:
        if (fd.label == PACKED) {
          if (x.ints.empty()) break;
          std::string data;
          for (int64_t v : x.ints) put_varint(&data, static_cast<uint64_t>(v));
          put_key(out, fd.number, 2);
          put_varint(out, data.size());
          out->append(data);
        } else {
          for (int64_t v : x.ints) {
            put_key(out, fd.number, 0);
            // a negative int32 or enum sign-extends to ten bytes
            put_varint(out, static_cast<uint64_t>(v));
          }
        }
    }
  }
  for (const Unknown& u : m.unknown) put_unknown(out, u);
}

// ---------------------------------------------------------------------------
// Text dump (DebugString)

std::string c_escape(const std::string& s) {
  std::string out;
  for (unsigned char c : s) {
    switch (c) {
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      case '\"': out += "\\\""; break;
      case '\'': out += "\\\'"; break;
      case '\\': out += "\\\\"; break;
      default:
        if (c < 0x20 || c >= 0x7F) {
          char buf[8];
          std::snprintf(buf, sizeof buf, "\\%03o", c);
          out += buf;
        } else {
          out.push_back(static_cast<char>(c));
        }
    }
  }
  return out;
}

std::string simple_dtoa(double v) {
  if (std::isnan(v)) return "nan";
  if (std::isinf(v)) return v > 0 ? "inf" : "-inf";
  char buf[64];
  std::snprintf(buf, sizeof buf, "%.*g", DBL_DIG, v);
  if (std::strtod(buf, nullptr) != v)
    std::snprintf(buf, sizeof buf, "%.*g", DBL_DIG + 2, v);
  return buf;
}

// Does `data` parse as a message of unknown fields to its end?
bool parse_unknown_set(const std::string& data, std::vector<Unknown>* out) {
  Reader r{reinterpret_cast<const uint8_t*>(data.data()),
           reinterpret_cast<const uint8_t*>(data.data()) + data.size()};
  while (!r.done()) {
    uint64_t key = r.varint();
    if (!r.ok) return false;
    int number = static_cast<int>(key >> 3), wire = static_cast<int>(key & 7);
    if (number == 0 || wire == 4) return false;
    Unknown u;
    if (!read_unknown(&r, number, wire, &u, 0)) return false;
    out->push_back(std::move(u));
  }
  return true;
}

void text_unknown(const std::vector<Unknown>& fields, int indent, int budget,
                  std::string* out) {
  std::string pad(indent, ' ');
  char buf[32];
  for (const Unknown& u : fields) {
    *out += pad + std::to_string(u.number);
    switch (u.wire) {
      case 0:
        *out += ": " + std::to_string(u.v) + "\n";
        break;
      case 1:
        std::snprintf(buf, sizeof buf, "%016" PRIx64, u.v);
        *out += ": 0x" + std::string(buf) + "\n";
        break;
      case 5:
        std::snprintf(buf, sizeof buf, "%08" PRIx32,
                      static_cast<uint32_t>(u.v));
        *out += ": 0x" + std::string(buf) + "\n";
        break;
      case 2: {
        std::vector<Unknown> sub;
        if (!u.bytes.empty() && budget > 0 && parse_unknown_set(u.bytes, &sub)) {
          *out += " {\n";
          text_unknown(sub, indent + 2, budget - 1, out);
          *out += pad + "}\n";
        } else {
          *out += ": \"" + c_escape(u.bytes) + "\"\n";
        }
        break;
      }
      case 3:
        *out += " {\n";
        text_unknown(u.group, indent + 2, budget - 1, out);
        *out += pad + "}\n";
        break;
    }
  }
}

void text(const Msg& m, int indent, std::string* out) {
  std::string pad(indent, ' ');
  const MsgDef* def = m.def;
  for (int i = 0; i < def->n_fields; ++i) {
    const FieldDef& fd = def->fields[i];
    const Field& x = m.at(fd.number);
    if (!x.has) continue;
    std::string head = pad + fd.name;
    switch (fd.type) {
      case MESSAGE:
        for (const Msg& sub : x.msgs) {
          *out += head + " {\n";
          text(sub, indent + 2, out);
          *out += pad + "}\n";
        }
        break;
      case STRING:
        for (const std::string& s : x.strs)
          *out += head + ": \"" + c_escape(s) + "\"\n";
        break;
      case DOUBLE:
        for (double d : x.dbls) *out += head + ": " + simple_dtoa(d) + "\n";
        break;
      case BOOL:
        for (int64_t v : x.ints) *out += head + (v ? ": true\n" : ": false\n");
        break;
      case ENUM:
        for (int64_t v : x.ints) *out += head + ": " + fd.names[v] + "\n";
        break;
      default:
        for (int64_t v : x.ints) *out += head + ": " + std::to_string(v) + "\n";
    }
  }
  text_unknown(m.unknown, indent, 10, out);
}

// ---------------------------------------------------------------------------
// Program walks

char* dup_bytes(const std::string& s, uint64_t* out_len) {
  char* p = static_cast<char*>(malloc(s.size() + 1));
  memcpy(p, s.data(), s.size());
  p[s.size()] = '\0';
  if (out_len) *out_len = s.size();
  return p;
}

// Does `name` resolve in block `idx` or any ancestor block?  Hop count is
// bounded by the block count so a cyclic parent_idx in corrupt bytes
// cannot wedge the validator.
bool resolves(const Msg& prog, int idx, const std::string& name) {
  const std::vector<Msg>& blocks = prog.msgs(P_BLOCKS);
  const int n = static_cast<int>(blocks.size());
  for (int hops = 0; idx >= 0 && idx < n && hops <= n; ++hops) {
    const Msg& b = blocks[idx];
    for (const Msg& v : b.msgs(B_VARS))
      if (v.get_str(V_NAME) == name) return true;
    idx = static_cast<int>(b.get_int(B_PARENT));
  }
  return false;
}

// All nested-block references of an op (while has one sub_block; cond has
// a block per branch).
std::vector<int> block_attrs(const Msg& op) {
  std::vector<int> out;
  for (const Msg& a : op.msgs(O_ATTRS))
    if (a.get_int(A_KIND) == kBlockKind)
      out.push_back(static_cast<int>(a.get_int(A_BLOCK_IDX)));
  return out;
}

const std::vector<std::string>& args(const Msg& slot) {
  return slot.at(S_ARGS).strs;
}

// Backward-reachability prune of one block: keep ops any of whose outputs
// are in `needed`; their inputs become needed (reference framework/prune.cc).
void prune_block(Msg* prog, int block_idx, std::set<std::string>* needed) {
  Msg& block = prog->msgs(P_BLOCKS)[block_idx];
  std::vector<Msg>& ops = block.msgs(B_OPS);
  std::vector<Msg> kept;
  for (int i = static_cast<int>(ops.size()) - 1; i >= 0; --i) {
    const Msg& op = ops[i];
    bool want = false;
    for (const Msg& slot : op.msgs(O_OUTPUTS))
      for (const std::string& arg : args(slot))
        if (needed->count(arg)) want = true;
    if (!want) continue;
    for (const Msg& slot : op.msgs(O_INPUTS))
      for (const std::string& arg : args(slot))
        if (!arg.empty()) needed->insert(arg);
    kept.push_back(op);
  }
  ops.assign(kept.rbegin(), kept.rend());
  block.at(B_OPS).has = !ops.empty();
}

// Blocks referenced (transitively) from block `idx`.
void live_blocks(const Msg& prog, int idx, std::set<int>* live) {
  if (!live->insert(idx).second) return;
  const std::vector<Msg>& blocks = prog.msgs(P_BLOCKS);
  for (const Msg& op : blocks[idx].msgs(B_OPS))
    for (int sub : block_attrs(op))
      if (sub >= 0 && sub < static_cast<int>(blocks.size()))
        live_blocks(prog, sub, live);
}

}  // namespace

extern "C" {

void pt_desc_free(char* p) { free(p); }

// Structural validation.  Returns 0 and *diag=NULL when clean; otherwise 1
// and *diag = malloc'd newline-separated diagnostics.
int pt_desc_validate(const uint8_t* buf, uint64_t len, char** diag) {
  Msg prog;
  if (!parse_program(buf, len, &prog)) {
    *diag = dup_bytes("parse error: bad ProgramDef bytes", nullptr);
    return 1;
  }
  const std::vector<Msg>& blocks = prog.msgs(P_BLOCKS);
  const int n_blocks = static_cast<int>(blocks.size());
  std::ostringstream out;
  if (n_blocks == 0) out << "program has no blocks\n";
  for (int bi = 0; bi < n_blocks; ++bi) {
    const Msg& b = blocks[bi];
    const int32_t idx = static_cast<int32_t>(b.get_int(B_IDX));
    const int32_t parent = static_cast<int32_t>(b.get_int(B_PARENT));
    if (idx != bi) out << "block " << bi << ": idx field says " << idx << "\n";
    if (parent >= n_blocks)
      out << "block " << bi << ": parent " << parent << " out of range\n";
    // ops may only read vars already produced, declared persistable/data,
    // or visible in a parent
    std::set<std::string> produced;
    for (const Msg& v : b.msgs(B_VARS))
      if (v.get_int(V_PERSISTABLE) || v.get_int(V_IS_DATA))
        produced.insert(v.get_str(V_NAME));
    const std::vector<Msg>& ops = b.msgs(B_OPS);
    for (int oi = 0; oi < static_cast<int>(ops.size()); ++oi) {
      const Msg& op = ops[oi];
      const std::string& type = op.get_str(O_TYPE);
      for (int sub : block_attrs(op))
        if (sub >= n_blocks)
          out << "block " << bi << " op " << oi << " (" << type
              << "): sub_block " << sub << " out of range\n";
      for (const Msg& slot : op.msgs(O_INPUTS))
        for (const std::string& arg : args(slot)) {
          if (arg.empty() || produced.count(arg)) continue;
          // declared but not yet produced is legal for feeds and
          // loop-carried vars; only undeclared names are errors
          if (!resolves(prog, bi, arg))
            out << "block " << bi << " op " << oi << " (" << type
                << "): input '" << arg << "' is undeclared\n";
        }
      for (const Msg& slot : op.msgs(O_OUTPUTS))
        for (const std::string& arg : args(slot)) {
          if (arg.empty()) continue;
          if (!resolves(prog, bi, arg))
            out << "block " << bi << " op " << oi << " (" << type
                << "): output '" << arg << "' is undeclared\n";
          produced.insert(arg);
        }
    }
  }
  std::string msg = out.str();
  if (msg.empty()) {
    *diag = nullptr;
    return 0;
  }
  *diag = dup_bytes(msg, nullptr);
  return 1;
}

// Prune the program to the ops needed for `targets` (newline-separated).
// Unreferenced nested blocks are dropped and block indices compacted.
// On success returns 0 and *out/*out_len hold the new serialized bytes.
int pt_desc_prune(const uint8_t* buf, uint64_t len, const char* targets,
                  char** out, uint64_t* out_len) {
  Msg prog;
  if (!parse_program(buf, len, &prog)) return 1;
  if (prog.msgs(P_BLOCKS).empty()) return 1;

  std::set<std::string> needed;
  std::istringstream ts(targets ? targets : "");
  std::string line;
  while (std::getline(ts, line))
    if (!line.empty()) needed.insert(line);

  prune_block(&prog, 0, &needed);

  // sub-blocks of surviving control-flow ops stay whole (their interior
  // dataflow is opaque to block-0 reachability)
  std::set<int> live;
  live_blocks(prog, 0, &live);

  // a new ProgramDef: version and random_seed always set, the program's
  // own unknown fields dropped; each kept block copied whole
  std::vector<Msg>& blocks = prog.msgs(P_BLOCKS);
  const int n = static_cast<int>(blocks.size());
  Msg pruned(&kProgramDef);
  pruned.set_int(P_VERSION, prog.get_int(P_VERSION, 1));
  pruned.set_int(P_SEED, prog.get_int(P_SEED, 0));
  std::vector<int> remap(n, -1);
  int next = 0;
  for (int bi = 0; bi < n; ++bi)
    if (live.count(bi)) remap[bi] = next++;
  for (int bi = 0; bi < n; ++bi) {
    if (remap[bi] < 0) continue;
    Msg nb = std::move(blocks[bi]);
    nb.set_int(B_IDX, remap[bi]);
    const int parent = static_cast<int32_t>(nb.get_int(B_PARENT));
    nb.set_int(B_PARENT,
               parent >= 0 && parent < n && remap[parent] >= 0 ? remap[parent]
                                                               : -1);
    for (Msg& op : nb.msgs(B_OPS))
      for (Msg& a : op.msgs(O_ATTRS))
        if (a.get_int(A_KIND) == kBlockKind) {
          const int b = static_cast<int>(a.get_int(A_BLOCK_IDX));
          a.set_int(A_BLOCK_IDX, b >= 0 && b < n ? remap[b] : -1);
        }
    pruned.msgs(P_BLOCKS).push_back(std::move(nb));
    pruned.at(P_BLOCKS).has = true;
  }

  std::string bytes;
  serialize(pruned, &bytes);
  *out = dup_bytes(bytes, out_len);
  return 0;
}

// JSON stats line: {"blocks":N,"ops":N,"vars":N,"params":N,"op_types":N}.
int pt_desc_stats(const uint8_t* buf, uint64_t len, char** out) {
  Msg prog;
  if (!parse_program(buf, len, &prog)) return 1;
  size_t ops = 0, vars = 0, params = 0;
  std::set<std::string> types;
  for (const Msg& b : prog.msgs(P_BLOCKS)) {
    ops += b.msgs(B_OPS).size();
    vars += b.msgs(B_VARS).size();
    for (const Msg& v : b.msgs(B_VARS))
      if (v.get_int(V_IS_PARAMETER)) ++params;
    for (const Msg& op : b.msgs(B_OPS)) types.insert(op.get_str(O_TYPE));
  }
  std::ostringstream js;
  js << "{\"blocks\":" << prog.msgs(P_BLOCKS).size() << ",\"ops\":" << ops
     << ",\"vars\":" << vars << ",\"params\":" << params
     << ",\"op_types\":" << types.size() << "}";
  *out = dup_bytes(js.str(), nullptr);
  return 0;
}

// Human-readable dump (protobuf's DebugString) for `paddle dump_config`.
int pt_desc_text(const uint8_t* buf, uint64_t len, char** out,
                 uint64_t* out_len) {
  Msg prog;
  if (!parse_program(buf, len, &prog)) return 1;
  std::string s;
  text(prog, 0, &s);
  *out = dup_bytes(s, out_len);
  return 0;
}

}  // extern "C"
