// Native host-side ops for the data pipeline: point-cloud IO, FOV filtering,
// rotated point-in-box tests, rotated BEV overlaps (a Sutherland–Hodgman
// polygon clip), the KITTI eval's matcher and PNG row un-filtering, with a C ABI loaded by ctypes from
// modest_tpu_torch/utils/native.py. The port's own copy of the JAX
// package's host library (the PNG un-filter is the port's own), built by
// g++ at first use into build/modest_tpu_torch/ with the same flags, so both
// give the same bits.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// IO: read a KITTI velodyne .bin into a caller-provided float32 buffer.
// Returns the number of points read, or -1 on error.
// ---------------------------------------------------------------------------
int64_t mh_load_velo(const char* path, float* out, int64_t max_floats) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t n = (int64_t)std::fread(out, sizeof(float), (size_t)max_floats, f);
    std::fclose(f);
    if (n % 4 != 0) return -1;
    return n / 4;
}

// ---------------------------------------------------------------------------
// FOV mask: points (n,4) velodyne → mask of points projecting inside the
// image. rect = R0 @ V2C (3x4, velodyne→rect), P (3x4 rect→image).
// ---------------------------------------------------------------------------
void mh_fov_mask(const float* pts, int64_t n, const double* rect,
                 const double* P, double img_h, double img_w, uint8_t* mask) {
    for (int64_t i = 0; i < n; i++) {
        const float* p = pts + i * 4;
        double r[3];
        for (int k = 0; k < 3; k++) {
            r[k] = rect[k * 4 + 0] * p[0] + rect[k * 4 + 1] * p[1] +
                   rect[k * 4 + 2] * p[2] + rect[k * 4 + 3];
        }
        double u = P[0] * r[0] + P[1] * r[1] + P[2] * r[2] + P[3];
        double v = P[4] * r[0] + P[5] * r[1] + P[6] * r[2] + P[7];
        double w = P[8] * r[0] + P[9] * r[1] + P[10] * r[2] + P[11];
        double uu = u / w, vv = v / w;
        double depth = w - P[11];
        mask[i] = (uu >= 0 && uu < img_w && vv >= 0 && vv < img_h && depth >= 0)
                      ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// points-in-rotated-boxes: boxes (m,7) [cx cy cz dx dy dz yaw] (center z).
// out_idx[i] = first containing box or -1.
// ---------------------------------------------------------------------------
void mh_points_in_boxes(const float* pts, int64_t n, int64_t stride,
                        const float* boxes, int64_t m, int32_t* out_idx) {
    for (int64_t i = 0; i < n; i++) {
        const float* p = pts + i * stride;
        int32_t hit = -1;
        for (int64_t b = 0; b < m && hit < 0; b++) {
            const float* bx = boxes + b * 7;
            float dz = p[2] - bx[2];
            if (std::fabs(dz) > bx[5] * 0.5f) continue;
            float c = std::cos(-bx[6]), s = std::sin(-bx[6]);
            float sx = p[0] - bx[0], sy = p[1] - bx[1];
            float lx = sx * c - sy * s;
            float ly = sx * s + sy * c;
            if (std::fabs(lx) <= bx[3] * 0.5f && std::fabs(ly) <= bx[4] * 0.5f)
                hit = (int32_t)b;
        }
        out_idx[i] = hit;
    }
}

// ---------------------------------------------------------------------------
// rotated BEV overlap areas via Sutherland–Hodgman polygon clipping.
// boxes: (?,7) [cx cy cz dx dy dz yaw]; out: (na, nb) intersection areas.
// ---------------------------------------------------------------------------
namespace {

struct Pt { double x, y; };

inline void corners_of(const float* b, Pt* c) {
    double cx = b[0], cy = b[1], dx = b[3] * 0.5, dy = b[4] * 0.5, a = b[6];
    double ca = std::cos(a), sa = std::sin(a);
    const double lx[4] = {-dx, dx, dx, -dx};
    const double ly[4] = {-dy, -dy, dy, dy};
    for (int k = 0; k < 4; k++) {
        c[k].x = lx[k] * ca - ly[k] * sa + cx;
        c[k].y = lx[k] * sa + ly[k] * ca + cy;
    }
}

inline double polygon_area(const Pt* poly, int n) {
    double area = 0;
    for (int i = 0; i < n; i++) {
        int j = (i + 1) % n;
        area += poly[i].x * poly[j].y - poly[j].x * poly[i].y;
    }
    return std::fabs(area) * 0.5;
}

// clip polygon by the half-plane left of edge a→b (CCW clip polygon)
inline int clip_edge(const Pt* in, int n, Pt a, Pt b, Pt* out) {
    int m = 0;
    double ex = b.x - a.x, ey = b.y - a.y;
    for (int i = 0; i < n; i++) {
        const Pt& cur = in[i];
        const Pt& nxt = in[(i + 1) % n];
        double dc = ex * (cur.y - a.y) - ey * (cur.x - a.x);
        double dn = ex * (nxt.y - a.y) - ey * (nxt.x - a.x);
        bool cin = dc <= 0, nin = dn <= 0;  // inside = right side for CW, handle both below
        if (cin) out[m++] = cur;
        if (cin != nin) {
            double t = dc / (dc - dn);
            out[m].x = cur.x + t * (nxt.x - cur.x);
            out[m].y = cur.y + t * (nxt.y - cur.y);
            m++;
        }
    }
    return m;
}

inline double box_pair_overlap(const float* ba, const float* bb) {
    Pt ca[4], cb[4];
    corners_of(ba, ca);
    corners_of(bb, cb);
    // our corner order is CCW; "inside" for CCW clip edge a→b is the left
    // side: e×(p−a) >= 0. clip_edge uses dc<=0 (right side), so feed edges
    // reversed (b→a) to flip orientation.
    Pt poly[16], tmp[16];
    int n = 4;
    std::memcpy(poly, cb, sizeof(cb));
    for (int e = 0; e < 4 && n > 0; e++) {
        Pt a = ca[(e + 1) % 4], b = ca[e];
        n = clip_edge(poly, n, a, b, tmp);
        std::memcpy(poly, tmp, sizeof(Pt) * (size_t)n);
    }
    if (n < 3) return 0.0;
    return polygon_area(poly, n);
}

}  // namespace

void mh_bev_overlap(const float* boxes_a, int64_t na, const float* boxes_b,
                    int64_t nb, double* out) {
    for (int64_t i = 0; i < na; i++)
        for (int64_t j = 0; j < nb; j++)
            out[i * nb + j] = box_pair_overlap(boxes_a + i * 7, boxes_b + j * 7);
}

// BEV IoU on top of the overlap
void mh_bev_iou(const float* boxes_a, int64_t na, const float* boxes_b,
                int64_t nb, double* out) {
    mh_bev_overlap(boxes_a, na, boxes_b, nb, out);
    for (int64_t i = 0; i < na; i++) {
        double sa = (double)boxes_a[i * 7 + 3] * boxes_a[i * 7 + 4];
        for (int64_t j = 0; j < nb; j++) {
            double sb = (double)boxes_b[j * 7 + 3] * boxes_b[j * 7 + 4];
            double ov = out[i * nb + j];
            double un = sa + sb - ov;
            out[i * nb + j] = un > 1e-8 ? ov / un : 0.0;
        }
    }
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// KITTI eval matcher (compute_fp pass): for each score threshold, run the
// official greedy gt→det assignment and accumulate tp/fp/fn. No DontCare
// handling (metric>0 paths — BEV/3D — never have dc boxes in this pipeline).
// overlaps: (n_det, n_gt) row-major. out: (n_thresh, 3) int64 [tp, fp, fn].
// ---------------------------------------------------------------------------
void mh_match_stats(const double* overlaps, int64_t n_det, int64_t n_gt,
                    const double* scores, const int64_t* ignored_gt,
                    const int64_t* ignored_det, double min_overlap,
                    const double* thresholds, int64_t n_thresh, int64_t* out) {
    const double NO_DET = -1e7;
    bool* assigned = new bool[(size_t)(n_det > 0 ? n_det : 1)];
    for (int64_t t = 0; t < n_thresh; t++) {
        double thresh = thresholds[t];
        int64_t tp = 0, fp = 0, fn = 0;
        for (int64_t j = 0; j < n_det; j++) assigned[j] = false;
        for (int64_t i = 0; i < n_gt; i++) {
            if (ignored_gt[i] == -1) continue;
            int64_t det_idx = -1;
            double valid_detection = NO_DET;
            double max_overlap = 0;
            bool assigned_ignored = false;
            for (int64_t j = 0; j < n_det; j++) {
                if (ignored_det[j] == -1 || assigned[j] || scores[j] < thresh)
                    continue;
                double ov = overlaps[j * n_gt + i];
                if (ov > min_overlap &&
                    (ov > max_overlap || assigned_ignored) && ignored_det[j] == 0) {
                    max_overlap = ov;
                    det_idx = j;
                    valid_detection = 1;
                    assigned_ignored = false;
                } else if (ov > min_overlap && valid_detection == NO_DET &&
                           ignored_det[j] == 1) {
                    det_idx = j;
                    valid_detection = 1;
                    assigned_ignored = true;
                }
            }
            if (valid_detection == NO_DET && ignored_gt[i] == 0) {
                fn++;
            } else if (valid_detection != NO_DET &&
                       (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
                assigned[det_idx] = true;
            } else if (valid_detection != NO_DET) {
                tp++;
                assigned[det_idx] = true;
            }
        }
        for (int64_t j = 0; j < n_det; j++) {
            if (!assigned[j] && ignored_det[j] != -1 && ignored_det[j] != 1 &&
                scores[j] >= thresh)
                fp++;
        }
        out[t * 3 + 0] = tp;
        out[t * 3 + 1] = fp;
        out[t * 3 + 2] = fn;
    }
    delete[] assigned;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// PNG row un-filtering (PNG spec §9): src holds h rows of (1 filter byte +
// stride bytes), out receives the h × stride raw bytes. Sub, Average and
// Paeth read the un-filtered byte bpp to the left, Up, Average and Paeth the
// row above, so the loop runs in order along each row. Returns 0, or -(y + 1)
// for a row y with an unknown filter type.
// ---------------------------------------------------------------------------
int64_t mh_png_unfilter(const uint8_t* src, int64_t h, int64_t stride, int64_t bpp,
                        uint8_t* out) {
    for (int64_t y = 0; y < h; y++) {
        const uint8_t ft = src[y * (stride + 1)];
        const uint8_t* line = src + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
        for (int64_t i = 0; i < stride; i++) {
            const int a = i >= bpp ? cur[i - bpp] : 0;
            const int b = prev ? prev[i] : 0;
            const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
            int pred;
            switch (ft) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return -(y + 1);
            }
            cur[i] = (uint8_t)(line[i] + pred);
        }
    }
    return 0;
}

}  // extern "C"
